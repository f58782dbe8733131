"""The parallelism config — the one-device part of the JAX package's
``parallel/rules.py``: :class:`ParallelismConfig` with the same fields and
defaults.  On one device ``tp``, ``fsdp``, ``sp`` and ``ep`` shard nothing
(the JAX rules map a dim to a mesh axis only when the axis has more than
one device); ``remat``, ``microbatch`` and ``opt_dtype`` act.  The logical
axis rules, ``tree_shardings`` and ``batch_shardings`` come with the
multi-device slice: :func:`check_one_device` refuses a mesh of more than
one device until then.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ParallelismConfig:
    tp: bool = True            # tensor parallelism over 'model'
    fsdp: bool = False         # shard weight 'embed' dims over 'data'
    sp: bool = False           # sequence-parallel activation constraints
    ep: bool = True            # expert parallelism ('experts' -> 'model')
    remat: str = "dots"        # none | dots | full | 2level
    microbatch: int = 1        # gradient-accumulation steps
    donate_cache: bool = True
    opt_dtype: str = "float32"  # adam moment dtype


def check_one_device(**mesh_sizes: int) -> None:
    """Raise unless every named mesh axis has size 1 (the port runs on one
    device until the multi-device slice)."""
    wide = {k: v for k, v in mesh_sizes.items() if v != 1}
    if wide:
        raise ValueError(f"mesh axes {wide}: the port runs on one device "
                         "(sharding comes with the multi-device slice)")
