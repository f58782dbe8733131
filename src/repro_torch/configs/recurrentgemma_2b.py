"""recurrentgemma-2b — RG-LRU + local attention hybrid, 1 local-attn : 2 RG-LRU.

[arXiv:2402.19427; hf]  26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000.
Griffin-style block pattern: (RGLRU, RGLRU, LOCAL_ATTN) repeating; window 2048.
"""
from repro_torch.configs.base import LOCAL_ATTN, RGLRU, ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    layer_pattern=(RGLRU, RGLRU, LOCAL_ATTN),
    attn_window=2048,
    rglru_d_rnn=2560,
    tie_embeddings=True,
    rope_theta=10_000.0,
    source="arXiv:2402.19427; hf",
))
