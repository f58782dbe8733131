"""falcon-mamba-7b — attention-free Mamba-1 SSM stack.

[arXiv:2410.05355; unverified]  64L d_model=4096 d_ff=0 vocab=65024,
ssm_state=16, expand=2 (d_inner=8192), conv=4.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=65_024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    source="arXiv:2410.05355; unverified",
))
