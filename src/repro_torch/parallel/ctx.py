"""Activation sharding constraints via an ambient parallel context — the
port of the JAX package's ``parallel/ctx.py``.

Model code is mesh-agnostic; the launcher (dry-run / train loop / server)
installs ``parallel_context(mesh, pcfg)`` around a step, and layers call
``constrain(x, logical_axes)`` at the few points where propagation alone
picks a bad layout:

* attention with head counts not divisible by the model axis (phi3: 40H,
  arctic: 56H, whisper: 12H on 16): the query *sequence* dim is sharded
  over the model axis instead — sequence-parallel attention;
* MoE dispatch tensors (group dim -> data, expert dim -> model);
* SSM/RG-LRU scan inputs (channel dim -> model).

``constrain`` redistributes a ``DTensor`` to the spec's placements (the
counterpart of ``with_sharding_constraint``).  Outside a context, and on a
plain tensor, it is the identity.

GSPMD shards every op of a program, gathering an operand where it finds
no sharded form.  DTensor raises instead on an op it has no sharding
strategy for, on a view it cannot express on a shard, and on an op that
mixes DTensors with a partial sum.  Inside a context over a ``DeviceMesh``
the :class:`_GatherFallback` mode catches such a call, redistributes every
DTensor argument to ``Replicate``, runs the op on the local tensors and
hands back ``Replicate`` DTensors: XLA's gather, done at the same op.  The
calls it gathered are counted by name in :attr:`ParallelCtx.gathered`.
Plain tensors that meet DTensors count as replicated
(``implicit_replication``).
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import sys
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.parallel.rules import (ParallelismConfig, axis_names,
                                        mesh_sizes, partition_spec,
                                        placements)

_CTX: contextvars.ContextVar = contextvars.ContextVar("repro_torch_parallel_ctx",
                                                      default=None)
# whether the gather fallback is on the torch-function mode stack
_MODE_ON: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_parallel_mode_on", default=False)
# set inside local_region(): torch calls run on plain tensors, as written
_LOCAL: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_parallel_local", default=False)

# the modules whose torch calls the gather fallback handles: the models,
# the step builders and the planner's loop and region helpers
_STEP_CODE = ("repro_torch.models.", "repro_torch.runtime.",
              "repro_torch.core.")
# in-place Python operators (the Tensor methods ending in "_" are found by
# name)
_INPLACE_DUNDER = frozenset({"__setitem__", "__iadd__", "__isub__",
                             "__imul__", "__itruediv__", "__iand__",
                             "__ior__"})
# torch calls that run the backward: no op to gather, and handled with
# the mode on
_NOT_OPS = frozenset({"grad", "backward"})


@dataclass
class ParallelCtx:
    mesh: object
    pcfg: ParallelismConfig
    gathered: collections.Counter = field(default_factory=collections.Counter)

    @property
    def model_axis_size(self) -> int:
        return mesh_sizes(self.mesh).get("model", 1)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _flat(tree):
    if isinstance(tree, (list, tuple)):
        return [y for x in tree for y in _flat(x)]
    if isinstance(tree, dict):
        return [y for x in tree.values() for y in _flat(x)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, tuple):
        return tuple(_map(fn, x) for x in tree)
    if isinstance(tree, list):
        return [_map(fn, x) for x in tree]
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _replicate(mesh) -> list:
    from torch.distributed.tensor import Replicate
    return [Replicate()] * mesh.ndim


def _from_model_code() -> bool:
    """Whether the torch call being handled was made by the model or step
    code (:data:`_STEP_CODE`): by its frame, or by the frame that called
    the Python wrapper (``torch.nn.functional``, ``Tensor`` methods) which
    handed the call on through ``torch.overrides``.  A call torch makes
    itself (DTensor's redistribution, autograd functions) is not, nor is
    one of the data pipeline's or a launcher's."""
    f = sys._getframe(2)
    if f is not None and f.f_globals.get("__name__") == "torch.overrides":
        f = f.f_back.f_back if f.f_back is not None else None
    name = "" if f is None else f.f_globals.get("__name__", "")
    return name.startswith(_STEP_CODE)


def gather_local(x, mesh=None):
    """The whole tensor of a DTensor as a plain (local) tensor, by a
    differentiable redistribution to ``Replicate``; a plain tensor as it
    is."""
    if not _is_dtensor(x):
        return x
    mesh = mesh or x.device_mesh
    return x.redistribute(mesh, _replicate(mesh)).to_local()


def replicated_dtensor(t, mesh):
    """A plain tensor that every rank holds whole, as a ``Replicate``
    DTensor over ``mesh`` (differentiable)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, torch.Tensor) or _is_dtensor(t):
        return t
    return DTensor.from_local(t, mesh, _replicate(mesh), run_check=False)


class _GatherFallback(TorchFunctionMode):
    """Run a torch call as it is; when it fails on DTensor arguments, run
    it again on their gathered local tensors (module docstring).  An
    in-place call works on a gathered copy of its target, which is then
    redistributed back to the target's placements and copied into it.  A
    plain tensor that model code makes inside the step is made a
    ``Replicate`` DTensor (every rank makes the same one)."""

    def __init__(self, ctx: ParallelCtx):
        super().__init__()
        self.ctx = ctx

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _LOCAL.get() or not _from_model_code():
            return func(*args, **kwargs)
        if getattr(func, "__name__", "") in _NOT_OPS:
            # a mode is off inside its own handler, so through the whole
            # backward: a rematerialized forward puts it back (reentered)
            token = _MODE_ON.set(False)
            try:
                return func(*args, **kwargs)
            finally:
                _MODE_ON.reset(token)
        try:
            out = func(*args, **kwargs)
        except Exception as err:
            dts = [a for a in _flat((args, kwargs)) if _is_dtensor(a)]
            if not dts:
                raise
            error = err
        else:
            if any(_is_dtensor(a) for a in _flat((args, kwargs))):
                return out
            # a tensor made inside the step (a buffer, positions, a mask)
            # is the same on every rank: a Replicate DTensor
            return _map(lambda o: replicated_dtensor(o, self.ctx.mesh), out)
        name = getattr(func, "__name__", repr(func))
        mesh = dts[0].device_mesh
        inplace = name in _INPLACE_DUNDER or (
            name.endswith("_") and not name.startswith("_"))
        target = args[0] if inplace and args else None
        if inplace and not _is_dtensor(target):
            raise error
        if inplace and any(p.is_partial() for p in target.placements):
            raise ValueError(f"in-place {name} on a partial-sum DTensor: "
                             "constrain it first") from error
        self.ctx.gathered[name] += 1
        largs = list(_map(lambda a: gather_local(a, mesh), args))
        lkwargs = _map(lambda a: gather_local(a, mesh), kwargs)
        if inplace:
            largs[0] = largs[0].clone()
        out = func(*largs, **lkwargs)
        if not inplace:
            return _map(lambda o: replicated_dtensor(o, mesh), out)
        new = replicated_dtensor(largs[0], mesh).redistribute(
            mesh, target.placements)
        target.copy_(new)
        return None if name == "__setitem__" else target


def _scalar_replicas_span_the_mesh() -> None:
    """Make DTensor's spec of a plain 0-d tensor met in an op (autograd's
    backward formulas make such scalars: ``where(mask, grad, 0)``) name
    every mesh dim.  torch 2.11 gives it one ``Replicate`` whatever the
    mesh's rank, and on a 2-D mesh the next op's propagation fails
    (``(Replicate(),) != (1, 1)``); later releases give one a dim, as
    here.  Wraps the dispatcher's method once; a no-op where it is
    missing or already right."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor import _dispatch as D
    from torch.distributed.tensor._dtensor_spec import DTensorSpec

    cls = D.OpDispatcher
    orig = getattr(cls, "_try_replicate_spec_for_scalar_tensor", None)
    if orig is None or getattr(orig, "_spans_mesh", False):
        return

    def spanning(self, op_call, tensor_arg, compute_mesh):
        spec = orig(self, op_call, tensor_arg, compute_mesh)
        if len(spec.placements) != compute_mesh.ndim:
            spec = DTensorSpec(compute_mesh,
                               (Replicate(),) * compute_mesh.ndim,
                               tensor_meta=spec.tensor_meta)
        return spec

    spanning._spans_mesh = True
    cls._try_replicate_spec_for_scalar_tensor = spanning


@contextmanager
def parallel_context(mesh, pcfg: ParallelismConfig):
    """The ambient (mesh, pcfg) of :func:`constrain`; over a
    ``DeviceMesh`` also the gather fallback and implicit replication.
    Yields the :class:`ParallelCtx`."""
    ctx = ParallelCtx(mesh, pcfg)
    token = _CTX.set(ctx)
    try:
        with contextlib.ExitStack() as stack:
            if hasattr(mesh, "mesh_dim_names"):
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                from torch.utils.checkpoint import set_checkpoint_early_stop
                _scalar_replicas_span_the_mesh()
                stack.enter_context(implicit_replication())
                # a checkpointed unit's recompute runs whole: stopping it
                # early once the saved tensors are back loses track of
                # DTensor's collectives
                stack.enter_context(set_checkpoint_early_stop(False))
                stack.enter_context(reentered())
            yield ctx
    finally:
        _CTX.reset(token)


@contextmanager
def reentered():
    """The gather fallback of the ambient context put (back) on the mode
    stack, where it is not: a layer stack rematerialized in the backward
    (``torch.utils.checkpoint``) runs inside ``torch.autograd.grad``'s
    handler, with the mode off.  Nothing outside a context over a
    ``DeviceMesh``."""
    ctx = _CTX.get()
    if ctx is None or _MODE_ON.get() or not hasattr(ctx.mesh,
                                                    "mesh_dim_names"):
        yield
        return
    token = _MODE_ON.set(True)
    try:
        with _GatherFallback(ctx):
            yield
    finally:
        _MODE_ON.reset(token)


@contextmanager
def local_region():
    """Torch calls inside run as written on plain tensors: nothing is
    gathered or wrapped (a kernel's wrapper on local tensors)."""
    token = _LOCAL.set(True)
    try:
        yield
    finally:
        _LOCAL.reset(token)


def current() -> Optional[ParallelCtx]:
    return _CTX.get()


def constrain(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    """Redistribute a DTensor to the placements of ``axes`` under the
    ambient context (the identity without one, or on a plain tensor)."""
    ctx = _CTX.get()
    if ctx is None or not _is_dtensor(x):
        return x
    spec = partition_spec(tuple(x.shape), tuple(axes), ctx.mesh, ctx.pcfg,
                          kind="act")
    want = placements(spec, ctx.mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(ctx.mesh, want)


def gather_fsdp(w: torch.Tensor) -> torch.Tensor:
    """A weight as its layer uses it under FSDP (ZeRO-3): its shards over
    the data axes gathered, its model-axis shards kept; the backward
    reduce-scatters the gradient back.  The identity outside a context and
    on a plain tensor."""
    ctx = _CTX.get()
    if ctx is None or not _is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    names = axis_names(ctx.mesh)
    want = tuple(Replicate() if names[i] in ("pod", "data") else p
                 for i, p in enumerate(w.placements))
    if want == tuple(w.placements):
        return w
    return w.redistribute(ctx.mesh, want)


def block_offsets(x) -> tuple[list, list]:
    """(offset, size) per dim of this rank's block of the DTensor ``x``
    (the rules shard evenly; a dim on several mesh dims splits
    major-to-minor in mesh order, as DTensor lays it out)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    off, size = [0] * x.dim(), list(x.shape)
    for i, p in enumerate(x.placements):
        if p.is_shard():
            size[p.dim] //= mesh.size(i)
            off[p.dim] += coord[i] * size[p.dim]
    return off, size


def empty(shape, dtype, axes, kind: str, device) -> torch.Tensor:
    """``torch.empty``, or under a context over a ``DeviceMesh`` a DTensor
    laid out by the rules for ``axes`` whose rank allocates only its block
    (a cache made inside a step)."""
    ctx = _CTX.get()
    if ctx is None or not hasattr(ctx.mesh, "mesh_dim_names"):
        return torch.empty(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel.rules import local_shape
    spec = partition_spec(tuple(shape), tuple(axes), ctx.mesh, ctx.pcfg, kind)
    with local_region():
        block = torch.empty(local_shape(tuple(shape), spec, ctx.mesh),
                            dtype=dtype, device=device)
    return DTensor.from_local(block, ctx.mesh, placements(spec, ctx.mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_strides(shape))


def _contiguous_strides(shape) -> tuple:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def pad(x: torch.Tensor, pads: tuple, value: float = 0.0) -> torch.Tensor:
    """``F.pad`` (constant), and ``x`` itself when it pads nothing.  A
    DTensor is padded block by block when the padded dims are whole on
    every rank (else gathered first), keeping its placements: torch 2.11's
    DTensor gives ``constant_pad_nd`` a one-dim spec on a 2-D mesh."""
    import torch.nn.functional as F

    if not any(pads):
        return x
    if not _is_dtensor(x):
        return F.pad(x, pads, value=value)
    from torch.distributed.tensor import DTensor
    padded = {x.dim() - 1 - i // 2 for i, p in enumerate(pads) if p}
    if any(p.is_shard() and p.dim % x.dim() in padded
           for p in x.placements) or any(p.is_partial()
                                         for p in x.placements):
        x = x.redistribute(x.device_mesh, _replicate(x.device_mesh))
    local = F.pad(x.to_local(), pads, value=value)
    shape = list(x.shape)
    for d in padded:
        i = 2 * (x.dim() - 1 - d)
        shape[d] += pads[i] + pads[i + 1]
    return DTensor.from_local(local, x.device_mesh, x.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_strides(shape))


def heads_shardable(num_heads: int) -> bool:
    ctx = _CTX.get()
    if ctx is None:
        return True
    return num_heads % ctx.model_axis_size == 0
