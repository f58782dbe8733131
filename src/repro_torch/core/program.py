"""Offloadable-program abstraction — what the planner plans over.

A program declares its *regions* (the paper's loop statements), how to build
a runnable callable for a chosen offload pattern (``Impl``), and sample
inputs (the paper's "sample processing specified by the application" used for
verification-environment measurement).

``Region.analysis_args`` are ``device="meta"`` tensors: Step 2 and Step 3 run
the region on them, so the paper-size analysis allocates nothing.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.core.regions import Impl


@dataclass
class Region:
    """One offload candidate (paper: one loop statement)."""
    name: str
    analysis_fn: Callable            # the region's computation (its ref)
    analysis_args: tuple             # meta tensors at the full problem size
    # ranking tiebreakers: among equal-efficiency destinations the planner
    # prefers the declared deploy/measure variant (see planner rank_key)
    measure_variant: str = "offload"
    deploy_variant: str = "hopper"
    # compile-time knobs every variant of this region is called with (a
    # discovered region's ``causal``/``window``/``eps``); empty for the
    # annotated programs, which pass them at their own call sites
    static_kwargs: dict = field(default_factory=dict)

    def arg_signature(self) -> list[str]:
        """Abstract shapes/dtypes of the analysis args — the shape part of
        the plan-cache key."""
        return [f"{str(a.dtype).removeprefix('torch.')}"
                f"[{','.join(str(d) for d in a.shape)}]"
                for a in self.analysis_args]


@dataclass
class OffloadableProgram:
    """A whole application (paper: the C/C++ app given by the user)."""
    name: str
    regions: list[Region]
    build: Callable[[Impl], Callable]       # impl -> callable(*sample_args)
    # (seed, device) -> concrete args, drawn from a torch.Generator
    sample_inputs: Callable[[int, torch.device], tuple]
    device: torch.device                     # where samples and patterns run
    source_loop_count: int = 0               # loops in the original C source
    description: str = ""
    # measurement conditions folded into the plan-cache keys (e.g. the
    # batch/seq the sample runs at): anything that changes Step-4 timings
    # but not the regions' analysis args
    cache_extra: dict = field(default_factory=dict)


def meta(shape, dtype) -> torch.Tensor:
    """An analysis argument: shape and dtype only, no storage."""
    return torch.empty(shape, dtype=dtype, device="meta")
