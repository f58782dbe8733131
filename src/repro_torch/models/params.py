"""Parameter templates.

A model family defines ONE function returning a tree (nested dicts) of
:class:`ParamSpec`; ``init(template, generator)`` materializes it on the
generator's device (at full width, draw on the card: 12 B normals drawn
on the CPU and copied over would take minutes).

The init rules are the JAX package's (``models/params.py``), quirks
included: a ``scaled`` spec takes ``shape[0]`` as its fan-in, which for a
spec stacked along ``layers`` is the layer count.  The generator's numbers
differ from ``jax.random``'s, so tests that compare the two packages carry
the JAX parameters over with :mod:`repro_torch.models.convert`.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16, "int32": torch.int32}


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]      # logical axis name per dim
    init: str = "normal"   # normal | zeros | ones | scaled | a_log | neg_ones_i32
    scale: float = 1.0
    dtype: str = "bfloat16"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in rank")


def spec(shape: Sequence[int], axes: Sequence[Optional[str]],
         init: str = "normal", scale: float = 1.0,
         dtype: str = "bfloat16") -> ParamSpec:
    return ParamSpec(tuple(int(s) for s in shape), tuple(axes), init, scale,
                     dtype)


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a nested-dict tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def stacked(n: int, s: ParamSpec) -> ParamSpec:
    """Stack a per-layer spec along a leading (never-sharded) 'layers' dim."""
    return dataclasses.replace(s, shape=(n,) + s.shape,
                               axes=("layers",) + s.axes)


def stack_tree(n: int, tree):
    return tree_map(lambda s: stacked(n, s), tree)


def _normal(shape, factor: float, dtype, generator) -> torch.Tensor:
    """float32 normals times ``factor``, cast to ``dtype``; drawn one
    leading-dim slice at a time for stacked specs, so the float32 scratch
    stays the size of one layer."""
    dev = generator.device
    out = torch.empty(shape, dtype=dtype, device=dev)
    slices = [out] if len(shape) < 3 else list(out)
    for dst in slices:
        draw = torch.randn(dst.shape, generator=generator, device=dev,
                           dtype=torch.float32)
        dst.copy_(draw.mul_(factor))
    return out


def _materialize(s: ParamSpec, generator: torch.Generator) -> torch.Tensor:
    dt = DTYPES[s.dtype]
    dev = generator.device
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dt, device=dev)
    if s.init == "neg_ones_i32":
        return torch.full(s.shape, -1, dtype=dt, device=dev)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dt, device=dev)
    if s.init == "a_log":
        # mamba A_log init: log(1..N) broadcast over channels
        n = s.shape[-1]
        a = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev))
        return a.expand(s.shape).to(dt).contiguous()
    if s.init == "scaled":
        # shape[0]: for a stacked spec that is the layer count (as in JAX)
        fan_in = s.shape[0] if len(s.shape) >= 2 else max(math.prod(s.shape), 1)
        return _normal(s.shape, 1.0 / math.sqrt(fan_in), dt, generator)
    if s.init == "normal":
        fan_in = s.shape[-2] if len(s.shape) >= 2 else max(s.shape[-1], 1)
        return _normal(s.shape, s.scale / math.sqrt(fan_in), dt, generator)
    raise ValueError(f"unknown init {s.init!r}")


def init(template, generator: torch.Generator):
    """Materialize a template on ``generator.device``, leaf by leaf in the
    template's order."""
    return tree_map(lambda s: _materialize(s, generator), template)

