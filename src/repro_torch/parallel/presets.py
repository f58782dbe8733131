"""Per-(arch x shape) parallelism presets — the port of the JAX package's
``parallel/presets.py``, with the same choices: train with dots remat
(MoE: microbatch 1; dense: microbatch 4 from 12 B parameters), FSDP from
7 B parameters; serve without remat, FSDP where one model-axis shard of
the bf16 weights would exceed ~10 GB.  On one device (``model_axis=1``)
the sharding flags shard nothing; remat and microbatch act."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.parallel.rules import ParallelismConfig


def parallelism_for(cfg: ModelConfig, shape: ShapeConfig,
                    model_axis: int = 16) -> ParallelismConfig:
    params = cfg.param_count()
    bf16_bytes = params * 2
    if shape.kind == "train":
        fsdp = params >= 7e9
        if cfg.is_moe:
            return ParallelismConfig(tp=True, fsdp=fsdp, remat="dots",
                                     microbatch=1)
        micro = 4 if params >= 12e9 else 1
        return ParallelismConfig(tp=True, fsdp=fsdp, remat="dots",
                                 microbatch=micro)
    fsdp = (bf16_bytes / model_axis) > 10e9
    return ParallelismConfig(tp=True, fsdp=fsdp, remat="none", microbatch=1)
