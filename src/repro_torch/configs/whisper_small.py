"""whisper-small — encoder-decoder transformer with a real conv audio stem.

[arXiv:2212.04356; unverified]  12L d_model=768 12H (MHA kv=12) d_ff=3072
vocab=51865.  Encoder consumes 3000 mel frames (80-dim) through a two-layer
k=3 conv stem (stride 1 then stride 2 -> 1500 encoder positions, gelu after
each conv, as in the paper); the 12-layer decoder cross-attends.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,            # decoder layers
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51_865,
    encoder_layers=12,
    encoder_seq=1500,
    cross_attention=True,
    frontend="audio_stub",
    frontend_seq=3000,        # raw mel frames; conv2's stride-2 halves to 1500
    frontend_dim=80,          # 80 mel bins
    conv_stem=True,
    tie_embeddings=True,
    rope_theta=10_000.0,      # (whisper uses learned/sinusoidal; RoPE stands in)
    source="arXiv:2212.04356; unverified",
))
