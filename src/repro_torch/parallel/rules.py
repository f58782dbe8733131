"""Logical-axis -> mesh-axis sharding rules with divisibility fallback —
the port of the JAX package's ``parallel/rules.py``.

Every ParamSpec carries logical axis names ('embed', 'mlp', 'qkv', ...).
This module turns a tree of them into a tree of :class:`NamedSharding`
(a mesh and a per-dim spec, as JAX's) for a concrete or abstract mesh,
applying:

* DP   — 'batch' -> ('pod', 'data') jointly (or 'data' on a single pod)
* TP   — weight output/input dims ('mlp', 'qkv', 'vocab', 'experts', ...) -> 'model'
* FSDP — weight 'embed' dims additionally -> 'data' (ZeRO-3-style)
* EP   — 'experts' -> 'model' (expert parallelism shares the TP axis)
* SP   — sequence dim of activations -> 'model' (optional, constraint-based)

A dim maps to a mesh axis only when its size is divisible by the axis size
and the axis is not already used by another dim of the same tensor;
otherwise the mapping is skipped and the dim stays replicated.  A spec is a
tuple with one entry per tensor dim: None, a mesh axis name, or a tuple of
names sharded jointly (major to minor) — the entries of JAX's
``PartitionSpec``, so the two compare with ``tuple(jax_spec)``.
:func:`placements` turns a spec into DTensor placements over a
``DeviceMesh``.

A mesh here is a ``DeviceMesh`` with named dims, or an
:class:`~repro_torch.launch.mesh.AbstractMesh` (names and sizes only) that
the rules take without a process group.
"""
from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Optional

log = logging.getLogger("repro_torch.parallel")


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


# logical axis -> ordered candidate mesh axes. 'DP' is the joint data axes.
_PRIMARY: dict[str, tuple[str, ...]] = {
    "batch": ("DP",),
    "vocab": ("model",),
    "mlp": ("model",),
    "expert_mlp": (),          # experts dim already sharded over 'model'
    "qkv": ("model",),
    "kv_qkv": ("model",),
    "experts": ("model",),
    "inner": ("model",),
    "inner2": ("model",),
    "rnn": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "embed": (),               # FSDP adds 'data' (see below)
    "frontend": (),
    "layers": (),
    "seq": (),
    "ctx": (),                 # fallback only (see _FALLBACK)
    "act_seq": ("model",),     # sequence-parallel fallback for attention
    "act_embed": (),
}
# tried only if the dim is still unsharded after the primary pass
_FALLBACK: dict[str, tuple[str, ...]] = {
    "ctx": ("model",),         # e.g. qwen2 kv_heads=8 < model=16 -> shard cache seq
    # intra-expert tensor parallelism when the expert count doesn't divide
    # the model axis; 'data' covers serve-mode FSDP
    "expert_mlp": ("model", "data"),
}


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an abstract mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh_sizes(mesh))


def data_axes(mesh) -> tuple[str, ...]:
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _resolve(cand: str, mesh, pcfg: ParallelismConfig,
             kind: str) -> Optional[tuple[str, ...]]:
    """Map a rule candidate to concrete mesh axes (or None if disabled)."""
    names = axis_names(mesh)
    if cand == "DP":
        return data_axes(mesh) or None
    if cand == "model":
        if not pcfg.tp or "model" not in names:
            return None
        return ("model",)
    if cand == "data":
        if "data" not in names:
            return None
        return data_axes(mesh) if kind == "weight" else ("data",)
    return None


def partition_spec(shape: tuple[int, ...], axes: tuple[Optional[str], ...],
                   mesh, pcfg: ParallelismConfig,
                   kind: str = "weight") -> tuple:
    """The per-dim spec of one tensor (JAX's ``PartitionSpec`` entries)."""
    sizes = mesh_sizes(mesh)
    entries: list = [None] * len(shape)
    used: set[str] = set()

    def try_assign(i: int, cands: tuple[str, ...]) -> bool:
        for cand in cands:
            concrete = _resolve(cand, mesh, pcfg, kind)
            if not concrete or any(c in used for c in concrete):
                continue
            total = math.prod(sizes[c] for c in concrete)
            if shape[i] % total != 0:
                log.debug("fallback: dim %d (%s, size %d) not divisible by "
                          "%s (%d)", i, axes[i], shape[i], concrete, total)
                continue
            entries[i] = concrete if len(concrete) > 1 else concrete[0]
            used.update(concrete)
            return True
        return False

    for i, ax in enumerate(axes):
        if ax is None:
            continue
        cands = list(_PRIMARY.get(ax, ()))
        if ax == "embed" and pcfg.fsdp and kind == "weight":
            cands = ["data"] + cands
        try_assign(i, tuple(cands))
    for i, ax in enumerate(axes):
        if entries[i] is not None or ax is None:
            continue
        try_assign(i, _FALLBACK.get(ax, ()))
    return tuple(entries)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` over ``mesh``'s dims: ``Shard(d)`` on
    every mesh dim that tensor dim ``d`` names, ``Replicate()`` elsewhere.
    A dim on two axes jointly shards on both; DTensor splits over mesh dims
    in mesh order, so the names of a joint entry must come in that order —
    JAX's major-to-minor block order (pod-major for ``("pod", "data")``).
    A mesh dim of size 1 holds the whole tensor either way: it is
    ``Replicate()`` (DTensor cannot reshape a dim sharded on it)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_sizes(mesh)
    names = tuple(sizes)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"joint axes {group} are not in the mesh's "
                             f"order {names}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def local_shape(shape: tuple[int, ...], spec: tuple, mesh) -> tuple[int, ...]:
    """The shape of one device's block of a tensor laid out by ``spec``
    (the rules only shard evenly)."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            group = entry if isinstance(entry, tuple) else (entry,)
            out[d] //= math.prod(sizes[a] for a in group)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a per-dim spec (JAX's ``NamedSharding``)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _tree_map(fn, tree, is_leaf=lambda x: False):
    if isinstance(tree, dict) and not is_leaf(tree):
        return {k: _tree_map(fn, v, is_leaf) for k, v in tree.items()}
    return fn(tree)


def tree_shardings(template, mesh, pcfg: ParallelismConfig,
                   kind: str = "weight"):
    """NamedSharding tree for a ParamSpec template tree (same structure as
    the params/cache tree it describes)."""
    return _tree_map(lambda s: NamedSharding(
        mesh, partition_spec(s.shape, s.axes, mesh, pcfg, kind)), template)


def batch_shardings(batch_spec_tree, mesh, pcfg: ParallelismConfig):
    """Shard every batch input (anything with a ``shape``) on dim0 over
    the joint data axes."""
    dp = data_axes(mesh)
    sizes = mesh_sizes(mesh)

    def one(s):
        shape = tuple(s.shape)
        rest = (None,) * (len(shape) - 1)
        total = math.prod(sizes[a] for a in dp) if dp else 1
        if dp and shape and shape[0] % total == 0:
            spec = (dp if len(dp) > 1 else dp[0],) + rest
        elif "data" in sizes and shape and shape[0] % sizes["data"] == 0:
            spec = ("data",) + rest
        else:
            spec = (None,) * len(shape)
        return NamedSharding(mesh, spec)
    return _tree_map(one, batch_spec_tree)


def replicated(mesh):
    return NamedSharding(mesh, ())
