"""paligemma-3b — SigLIP frontend (a stub) + gemma decoder backbone.

[arXiv:2407.07726; hf]  18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216.
The SigLIP vision tower is a stub: a request carries 256 precomputed patch
embeddings of width 2,048, which ``w_front`` projects and the model
prepends to the token stream.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16_384,
    vocab_size=257_216,
    frontend="siglip_stub",
    frontend_seq=256,          # 16x16 patches at 224px
    frontend_dim=2048,
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="arXiv:2407.07726; hf",
))
