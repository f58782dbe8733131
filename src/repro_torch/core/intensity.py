"""Arithmetic-intensity analysis — the paper's Step 2 (PGI-tool analogue).

The paper runs an arithmetic-intensity tool over each loop statement and
keeps the top ``a``.  Here the "tool" is a ``TorchDispatchMode`` that runs
the region function on ``device="meta"`` tensors (shapes and dtypes only, no
storage, no arithmetic) and classifies every aten op it sees, in the classes
the JAX package's jaxpr walker uses: matrix products count
2 * out * contract flops, elementwise ops 1 per output element, reductions 1
per input element, transcendentals separately (weighted).  Boundary bytes
are the region's inputs plus outputs — the loop's "data size and access
count" — and

    AI = flops / boundary_bytes.

Loops are the :func:`repro_torch.core.loops.fori_loop` statements of the
region: under the counting pass each body runs once and its counts are
multiplied by the trip count, mirroring how trip counts raise the paper's
AI metric (and how the jaxpr walker treats a ``scan`` body).  An op the
classifier does not know lands in ``RegionAnalysis.unclassified``.

``alignment_penalty`` discounts regions whose innermost dims are not
multiples of 128, as in the JAX package, so both rank regions alike.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core.loops import observe_loops

# flop weight for transcendental ops (hardware transcendental units retire
# these slower than FMAs; the exact number only needs to rank loops)
TRANSCENDENTAL_WEIGHT = 8.0

_ELEMENTWISE_1 = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "neg", "abs",
    "floor", "ceil", "round", "sign", "sgn", "remainder", "fmod",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "logical_and",
    "logical_or", "logical_xor", "logical_not", "where", "clamp",
    "clamp_min", "clamp_max", "pow", "reciprocal",
    "eq", "ne", "lt", "le", "ge", "gt",
    "bitwise_left_shift", "bitwise_right_shift",
}
_TRANSCENDENTAL = {
    "exp", "log", "log1p", "expm1", "tanh", "sin", "cos", "tan", "rsqrt",
    "sqrt", "sigmoid", "erf", "erfinv", "atan2", "exp2",
}
_REDUCE = {"sum", "mean", "amax", "amin", "prod", "argmax", "argmin",
           "cumsum", "cumprod", "cummax", "cummin", "all", "any"}
# matrix products: index of the operand whose last dim is contracted
_MATMUL = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "vdot": 0,
           "addmm": 1, "addmv": 1, "baddbmm": 1}

# explicitly zero-flop: data movement / layout / allocation.  Classifying
# them (instead of silently falling through) keeps `unclassified` an honest
# to-do list.
_ZERO_FLOP = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "t", "transpose",
    "permute", "expand", "squeeze", "unsqueeze", "slice", "select", "narrow",
    "index", "index_select", "gather", "scatter", "index_put", "cat",
    "stack", "split", "split_with_sizes", "unbind", "constant_pad_nd",
    "flip", "roll", "clone", "copy", "_to_copy", "detach", "alias",
    "lift_fresh", "lift_fresh_copy", "empty", "empty_like", "empty_strided",
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "fill",
    "zero", "new_zeros", "new_empty", "new_full", "new_ones",
    "scalar_tensor", "arange", "view_as_real", "view_as_complex", "real",
    "imag", "conj", "_conj", "resolve_conj", "resolve_neg", "unfold",
    "as_strided", "isfinite",
}


@dataclass
class RegionAnalysis:
    name: str = ""
    flops: float = 0.0              # raw counts — never penalty-discounted,
    transcendentals: float = 0.0    # so roofline projections stay honest
    boundary_bytes: float = 0.0
    loop_count: int = 0             # fori_loop statements
    max_trip: float = 1.0
    alignment: float = 1.0          # layout penalty, applied at ranking time
    # ops the classifier could not place (name -> occurrences): any entry
    # here means the flop count may be low for this region
    unclassified: dict = field(default_factory=dict)

    @property
    def weighted_flops(self) -> float:
        # the penalty discounts the WHOLE weighted total, transcendentals too
        return self.alignment * (
            self.flops + TRANSCENDENTAL_WEIGHT * self.transcendentals)

    @property
    def arithmetic_intensity(self) -> float:
        return self.weighted_flops / max(self.boundary_bytes, 1.0)


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts the aten ops of one run into a :class:`RegionAnalysis`, and
    observes :func:`~repro_torch.core.loops.fori_loop` (one body run,
    counts scaled by the trip).  Also records the op count and the largest
    op output — Step 3's size figures for a plain-PyTorch variant."""

    def __init__(self, acc: RegionAnalysis):
        super().__init__()
        self.acc = acc
        self.mult = 1.0
        self.n_ops = 0
        self.largest_bytes = 0

    def loop(self, trip: int, run_once):
        self.acc.loop_count += 1
        outer = self.mult
        self.mult = outer * trip
        self.acc.max_trip = max(self.acc.max_trip, self.mult)
        try:
            return run_once()
        finally:
            self.mult = outer

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self._count(func, args, out)
        return out

    def _count(self, func, args, out) -> None:
        self.n_ops += 1
        outs = _tensors(out)
        for t in outs:
            self.largest_bytes = max(self.largest_bytes, _nbytes(t))
        name = func.overloadpacket.__name__
        if name.endswith("_") and not name.endswith("__"):
            name = name[:-1]                      # in-place form
        out_elems = sum(t.numel() for t in outs)
        acc, m = self.acc, self.mult
        if name in _MATMUL:
            lhs = args[_MATMUL[name]]
            acc.flops += m * 2.0 * out_elems * lhs.shape[-1]
            if _MATMUL[name]:                     # the fused bias add
                acc.flops += m * out_elems
        elif name in ("max", "min"):
            if func._overloadname == "other":     # binary: elementwise
                acc.flops += m * out_elems
            else:                                 # reduction
                acc.flops += m * args[0].numel()
        elif name == "pow" and isinstance(args[1], int):
            acc.flops += m * 2.0 * out_elems      # JAX's integer_pow weight
        elif name in _TRANSCENDENTAL:
            acc.transcendentals += m * out_elems
        elif name in _ELEMENTWISE_1:
            acc.flops += m * out_elems
        elif name in _REDUCE:
            acc.flops += m * args[0].numel()
        elif name not in _ZERO_FLOP:
            acc.unclassified[name] = acc.unclassified.get(name, 0) + 1


def to_meta(args) -> tuple:
    """Shape/dtype-only copies of ``args`` (meta tensors pass through)."""
    return tuple(a if not isinstance(a, torch.Tensor) or a.is_meta
                 else torch.empty_like(a, device="meta") for a in args)


def count_ops(fn, args) -> tuple[OpCounter, object]:
    """Run ``fn`` on meta copies of ``args`` under an :class:`OpCounter`;
    returns the counter and ``fn``'s (meta) output."""
    counter = OpCounter(RegionAnalysis())
    args = to_meta(args)
    with counter, observe_loops(counter):
        out = fn(*args)
    return counter, out


def alignment_penalty(tensors) -> float:
    """1.0 if the innermost dims are vector-unit friendly (multiples of 128,
    or >= 512); down to 0.25 for scalar-ish shapes (paper's FPGA-clock
    caveat: the offload only wins when the loop suits the accelerator)."""
    score = 1.0
    for t in tensors:
        if not t.shape:
            continue
        last = t.shape[-1]
        if last % 128 == 0:
            continue
        if last >= 512:
            score = min(score, 0.9)
        elif last >= 128:
            score = min(score, 0.75)
        else:
            score = min(score, 0.25)
    return score


def analyze_region(fn, *args, name: str = "") -> RegionAnalysis:
    """AI analysis of ``fn(*args)``.  Args may be tensors on any device;
    the analysis runs on meta copies (nothing executes)."""
    counter, out = count_ops(fn, args)
    acc = counter.acc
    acc.name = name
    ins = _tensors(args)
    acc.boundary_bytes = float(sum(_nbytes(t) for t in ins)
                               + sum(_nbytes(t) for t in _tensors(out)))
    acc.alignment = alignment_penalty(ins)
    return acc


def count_loops(fn, *args) -> int:
    """Total loop statements (``fori_loop``) in one run of the program —
    the Step-1 'code analysis' loop census (Clang-parse analogue)."""
    return count_ops(fn, args)[0].acc.loop_count
