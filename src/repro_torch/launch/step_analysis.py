"""Per-device cost of one step under a mesh — the counterpart of the JAX
package's ``launch/hlo_analysis.py``.

JAX reads the cost off the SPMD-partitioned HLO text (local shapes) and
multiplies each ``while`` body by its trip count.  The port runs the step
eagerly, on DTensors over a process group (in the dry-run a ``"fake"``
group under ``FakeTensorMode``), so every loop iteration is seen and
there is no trip count to attribute.  :class:`StepCounter`, a
``TorchDispatchMode``, sees each op that a rank runs on its local tensors:
it lets a DTensor op through to DTensor (returns ``NotImplemented``), and
counts the local ops DTensor then issues.  DTensor's sharding propagator
also runs each op once at its global shapes to infer the output's
metadata; those calls are not counted (:func:`_skip_propagation`).  So
the counts are **per device**, of rank 0's shards.

Cost model (per device), JAX's:
* flops        — matrix products and convolutions: torch's flop formulas
                 (``torch.utils.flop_counter``), 2 * M * N * K for a
                 product
* hbm bytes    — input + output bytes of every op that moves data
                 (``hbm_bytes``: all non-view ops, a zero-fusion upper
                 bound; ``hbm_fused``: products, copies, gathers,
                 reductions, concatenations and collectives only, the
                 fusion-optimistic roofline term)
* collectives  — JAX's ring model per participating device: all-reduce
                 2 x size, all-gather / reduce-scatter the full size,
                 all-to-all / permute the size
* transcendentals — element counts of exp/log/tanh/rsqrt/sqrt/sin/cos/...
* memory       — argument bytes (the step's inputs, local blocks), output
                 bytes (outputs not aliasing an input) and temp bytes (the
                 peak of live storage beyond them), from storage lifetimes
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_VIEW_OPS = {"view", "_unsafe_view", "reshape", "expand", "permute",
             "transpose", "t", "select", "slice", "unsqueeze", "squeeze",
             "as_strided", "alias", "detach", "split", "split_with_sizes",
             "chunk", "unbind", "view_as", "expand_as", "narrow",
             "lift_fresh", "empty", "empty_strided",
             "empty_like", "new_empty", "new_empty_strided", "_local_scalar_dense",
             "wait_tensor", "device", "sym_size", "sym_stride", "dim",
             "is_same_size", "_has_compatible_shallow_copy_type"}
# the ops a well-fusing compile must still move through HBM (JAX's
# _HBM_OPS): products, explicit data movement, gathers, reductions,
# collectives
_HBM_OPS = {"mm", "addmm", "bmm", "baddbmm", "convolution", "copy_",
            "_to_copy", "clone", "index", "index_put_", "index_put",
            "index_select", "gather", "scatter", "scatter_add", "scatter_add_",
            "index_add", "index_add_", "slice_scatter", "select_scatter",
            "cat", "constant_pad_nd", "sum", "mean", "amax", "amin", "max",
            "min", "logsumexp", "_softmax", "sort", "topk", "cumsum",
            "embedding", "all_reduce", "all_gather_into_tensor",
            "reduce_scatter_tensor", "all_to_all_single"}
# op -> transcendentals per output element
_TRANSCENDENTAL = {"exp": 1, "exp_": 1, "expm1": 1, "log": 1, "log1p": 1,
                   "tanh": 1, "rsqrt": 1, "sqrt": 1, "pow": 1, "sin": 1,
                   "cos": 1, "sigmoid": 1, "silu": 1, "gelu": 1,
                   "softplus": 2, "_softmax": 1, "logsumexp": 1,
                   "_log_softmax": 2}
_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "broadcast": "collective-permute"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _bytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _is_dtensor(t) -> bool:
    return hasattr(t, "to_local") and hasattr(t, "placements")


@dataclass
class StepCost:
    flops: float = 0.0
    hbm_bytes: float = 0.0          # zero-fusion upper bound
    hbm_fused: float = 0.0          # fusion-optimistic (roofline memory term)
    transcendentals: float = 0.0
    collective_bytes: dict = field(default_factory=lambda: defaultdict(float))
    collective_counts: dict = field(default_factory=lambda: defaultdict(int))
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    alias_bytes: float = 0.0
    temp_bytes: float = 0.0
    ops: int = 0

    @property
    def total_collective_bytes(self) -> float:
        return float(sum(self.collective_bytes.values()))

    def to_json(self) -> dict:
        """The keys of JAX's ``HloCost.to_json`` (``trip_counts`` empty:
        an eager step sees every iteration)."""
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "hbm_fused": self.hbm_fused,
                "transcendentals": self.transcendentals,
                "collective_bytes": dict(self.collective_bytes),
                "collective_counts": dict(self.collective_counts),
                "total_collective_bytes": self.total_collective_bytes,
                "trip_counts": [], "local_ops": self.ops}

    def memory_json(self) -> dict:
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": self.temp_bytes,
                "alias_bytes": self.alias_bytes, "code_bytes": 0}


_PROPAGATING = [0]           # > 0 while DTensor infers an op's metadata


@contextlib.contextmanager
def _skip_propagation():
    """Mark DTensor's shape inference (it runs each op at global shapes
    on fake tensors) so :class:`StepCounter` does not count it.  Raises if
    the torch release lacks the hook, rather than count global work."""
    from torch.distributed.tensor import _sharding_prop as SP

    cls = SP.ShardingPropagator
    name = next((n for n in ("_propagate_tensor_meta_non_cached",
                             "_propagate_tensor_meta") if hasattr(cls, n)),
                None)
    if name is None:
        raise RuntimeError("step_analysis: this torch's ShardingPropagator "
                           "has no _propagate_tensor_meta hook")
    orig = getattr(cls, name)

    def hooked(self, *args, **kwargs):
        _PROPAGATING[0] += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            _PROPAGATING[0] -= 1

    setattr(cls, name, hooked)
    try:
        yield
    finally:
        setattr(cls, name, orig)


class StepCounter(TorchDispatchMode):
    """Counts the local ops of a step (module docstring).  Use as

        counter = StepCounter()
        counter.arguments(inputs)
        with counter:
            out = step(*inputs)
        counter.outputs(out)
        cost = counter.cost
    """

    def __init__(self):
        super().__init__()
        self.cost = StepCost()
        self._live: dict[int, float] = {}
        self._args: set[int] = set()
        self._cur = 0.0
        self._peak = 0.0
        self._stack = contextlib.ExitStack()

    # -- storage lifetimes --------------------------------------------
    def _track(self, t: torch.Tensor) -> int:
        if _is_dtensor(t):
            t = t.to_local()
        st = t.untyped_storage()
        key = id(st)
        if key not in self._live:
            n = float(st.nbytes())
            self._live[key] = n
            self._cur += n
            self._peak = max(self._peak, self._cur)
            weakref.finalize(st, self._release, key)
        return key

    def _release(self, key: int) -> None:
        n = self._live.pop(key, 0.0)
        self._cur -= n

    def arguments(self, tree) -> None:
        """Register the step's inputs (before it runs)."""
        for t in _tensors(tree):
            self._args.add(self._track(t))
        self.cost.argument_bytes = self._cur
        self._peak = self._cur

    def outputs(self, tree) -> None:
        """Register the step's outputs (after it ran) and close the
        memory account."""
        seen: set[int] = set()
        for t in _tensors(tree):
            key = self._track(t)
            if key in seen:
                continue
            seen.add(key)
            if key in self._args:
                self.cost.alias_bytes += self._live[key]
            else:
                self.cost.output_bytes += self._live[key]
        self.cost.temp_bytes = max(
            self._peak - self.cost.argument_bytes - self.cost.output_bytes,
            0.0)

    # -- the mode -------------------------------------------------------
    def __enter__(self):
        self._stack.enter_context(_skip_propagation())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor(t) for t in _tensors((args, kwargs))):
            return NotImplemented           # DTensor runs it locally
        out = func(*args, **kwargs)
        if _PROPAGATING[0]:
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        name = func._overloadpacket.__name__
        if name in _VIEW_OPS:
            return
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        c = self.cost
        c.ops += 1
        for t in outs:
            self._track(t)
        packet = func._overloadpacket
        if packet in flop_registry:
            c.flops += float(flop_registry[packet](*args, **kwargs,
                                                   out_val=out))
        moved = sum(map(_bytes, ins)) + sum(map(_bytes, outs))
        c.hbm_bytes += moved
        if name in _HBM_OPS:
            c.hbm_fused += moved
        if name in _TRANSCENDENTAL and outs:
            c.transcendentals += _TRANSCENDENTAL[name] * outs[0].numel()
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            full = max([_bytes(t) for t in ins + outs] or [0.0])
            c.collective_bytes[kind] += (2.0 if kind == "all-reduce"
                                         else 1.0) * full
            c.collective_counts[kind] += 1
