"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8 (paper-table).

[arXiv:2501.kimi2; unverified]  61L d_model=7168 64H (GQA kv=8) moe_d_ff=2048
vocab=163840, MoE 384e top-8.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,            # assignment lists d_ff=2048 (per-expert width)
    vocab_size=163_840,
    num_experts=384,
    experts_per_token=8,
    moe_d_ff=2048,
    capacity_factor=1.25,
    rope_theta=50_000.0,
    source="arXiv:2501.kimi2; unverified",
))
