"""mixtral-8x7b — BONUS arch (not in the assignment; demonstrates config
extensibility).  8-expert top-2 MoE, public config.

[arXiv:2401.04088; hf:mistralai/Mixtral-8x7B-v0.1]  32L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=32_000,
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=14_336,
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088; hf (BONUS, unassigned)",
))
