"""Static extraction over captured aten graphs — Step 1 for *unannotated*
programs, the port of the JAX package's ``core/extract.py``.

The paper's Step 1 is a Clang-based static pass that enumerates an
application's loop statements before any measurement happens.  The
annotated path (``make_lm_program``, ``apps/``) plays that role by hand:
someone decides which blocks are regions.  This module is the automatic
version: capture a function as an aten graph, walk it, and statically
recognize the computational blocks the port's kernel registry knows how
to offload (``attn_core``, ``mlp_core``, ``mlp_gelu``, ``conv_stem``,
``ssm_scan``, ``rglru_scan``, ``fir_bank``, ``moe_dispatch``,
``rmsnorm``).  Adjacent legal matches are
also *stitched* into fused regions (``left+right``) the planner prices
against their split forms, and every near-miss is recorded as a structured
:class:`Rejection`.
The result is an :class:`~repro_torch.core.program.OffloadableProgram` that
flows into the planner and the plan cache unchanged.

Layers
------
capture
    :func:`capture`: ``make_fx`` over ``torch.func.functionalize`` on fake
    tensors, so nothing is allocated and the in-place writes of the ``ref``
    variants become scatter ops a backward slice can cover.  Closed-over
    weights become ``get_attr`` constants (references, not copies).  Every
    :func:`~repro_torch.core.loops.fori_loop` runs all its iterations under
    the capture protocol of ``core/loops.py``, and each node is tagged
    (``node.meta["repro_loop"]``) with its loop statements and iterations,
    outermost first; a statement's trip count is in :class:`LoopStmt`.
enumerator
    :func:`enumerate_sites` / ``_Ctx``: the root graph plus the subgraphs
    of the ``cond`` and ``while_loop`` higher-order ops, and the candidate
    sites: loop statements (recognizers read a statement's structure from
    its iteration 0, as the JAX recognizers read a ``scan`` body),
    ``while_loop`` nodes, and ``rsqrt`` (norm), ``silu``/``sigmoid``
    (gate), ``tanh``/``gelu`` (act), ``convolution`` (conv) and
    ``topk``/``sort`` (route) anchors.
recognizers
    ``_match_*``: structural matchers from a site to a :class:`RegionMatch`
    — the family, the graph nodes that become the variant's arguments and
    results, the covered node set, the static kwargs.  Each reads the
    port's own formulation of the region's ``ref`` in aten ops.
legality
    ``_legalize``: nothing inside ``while``/``cond`` is offloadable, no
    covered value may feed a mutation of a program input (a side effect
    that survived functionalization), no covered intermediate may escape,
    dtype gates, a registered non-``ref`` variant, and the Step-2 numbers
    from :func:`~repro_torch.core.intensity.analyze_region` on meta copies
    of the arguments.
binder
    ``_region_fn`` makes a match's covered nodes a standalone callable (the
    region's ``analysis_fn``), and ``_make_build`` rewrites the captured
    graph for an offload pattern: each active match's covered nodes become
    one call of :func:`~repro_torch.core.regions.dispatch`.

Entry points: :func:`extract` (analysis only, returns an
:class:`ExtractionReport`) and :func:`discover` (the planner-ready
``OffloadableProgram``).
"""
from __future__ import annotations

import contextlib
import importlib
import itertools
import operator
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
import torch.fx as fx
from torch.fx.experimental.proxy_tensor import get_proxy_mode, make_fx

from repro_torch.core import loops
from repro_torch.core.intensity import RegionAnalysis, analyze_region
from repro_torch.core.program import OffloadableProgram, Region, meta
from repro_torch.core.regions import REGISTRY, Impl, dispatch, register_variant

# families this pass can recognize, in recognizer precedence order
FAMILIES = ("attn_core", "ssm_scan", "rglru_scan", "fir_bank", "moe_dispatch",
            "conv_stem", "mlp_gelu", "mlp_core", "rmsnorm")

# dtypes the registered kernel variants accept (legality gate)
_FLOAT_OK = ("bfloat16", "float32")
_FIR_OK = ("complex64", "float32")

# pure data-layout ops (peelable during operand recovery)
_LAYOUT = ("view", "_unsafe_view", "reshape", "transpose", "permute",
           "squeeze", "unsqueeze", "expand", "slice", "clone", "alias")
# the ops between a loop's carried value and its update
_CARRY_CHAIN = ("unsqueeze", "expand", "view", "_unsafe_view", "reshape",
                "_to_copy", "alias", "clone")
_MATMUL = ("mm", "bmm")
_LOOP_KEY = "repro_loop"
# exceptions of a fake-tensor capture that met a value-dependent branch
_DATA_DEPENDENT = ("GuardOnDataDependentSymNode",
                   "DataDependentOutputException",
                   "DynamicOutputShapeException")


def _op(n) -> str:
    """The op name of a node: the aten packet (``"mul"``, ``"rsqrt"``), the
    higher-order op (``"cond"``, ``"while_loop"``), ``"getitem"``, or ""
    for placeholders, constants and the output."""
    if not isinstance(n, fx.Node) or n.op != "call_function":
        return ""
    packet = getattr(n.target, "overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(n.target, "__name__", str(n.target))


def _val(n):
    v = n.meta.get("val") if isinstance(n, fx.Node) else None
    return v if isinstance(v, torch.Tensor) else None


def _shape(n) -> tuple:
    v = _val(n)
    return tuple(int(d) for d in v.shape) if v is not None else ()


def _dtype(n) -> str:
    v = _val(n)
    return str(v.dtype).removeprefix("torch.") if v is not None else ""


def _frames(n) -> tuple:
    """((loop statement, iteration), ...) of a node, outermost first."""
    return n.meta.get(_LOOP_KEY, ())


def _is_scalar(a) -> bool:
    return isinstance(a, (int, float)) or (isinstance(a, fx.Node)
                                           and _val(a) is not None
                                           and _shape(a) == ())


# ---------------------------------------------------------------------------
# Capture
# ---------------------------------------------------------------------------
@dataclass
class LoopStmt:
    """One ``fori_loop`` call met during the capture.  ``parent`` is the
    (statement, iteration) it was called from; ``depth`` the number of
    loop statements around it."""
    id: int
    trip: int
    parent: Optional[tuple]
    depth: int


class _LoopTagger:
    """The capture protocol of ``core/loops.py``: records each loop
    statement and tags the nodes each iteration adds to the graph being
    traced (inner iterations first, so a node keeps its innermost frame)."""

    def __init__(self):
        self.stmts: list[LoopStmt] = []
        self.frames: list[tuple] = []

    def open_loop(self, trip: int) -> int:
        parent = self.frames[-1] if self.frames else None
        stmt = LoopStmt(len(self.stmts), trip, parent, len(self.frames))
        self.stmts.append(stmt)
        return stmt.id

    @contextlib.contextmanager
    def iteration(self, stmt: int, k: int):
        mode = get_proxy_mode()
        graph = mode.tracer.graph if mode is not None else None
        start = len(graph.nodes) if graph is not None else 0
        self.frames.append((stmt, k))
        try:
            yield
        finally:
            tag = tuple(self.frames)
            self.frames.pop()
            if graph is not None:
                for node in itertools.islice(reversed(graph.nodes),
                                             len(graph.nodes) - start):
                    node.meta.setdefault(_LOOP_KEY, tag)


def _data_dependent(e: BaseException) -> bool:
    return any(t.__name__ in _DATA_DEPENDENT for t in type(e).__mro__)


def capture(fn: Callable, args: tuple) -> tuple[fx.GraphModule, list]:
    """``fn(*args)`` as a functionalized aten graph traced on fake tensors,
    dead code removed, and its loop statements.  ``args`` may be concrete,
    meta or fake tensors (fake ones keep their fake mode, so a capture can
    stand for a CUDA program on a machine without a card).  Raises
    ``ValueError`` naming the op where the program's control flow or
    shapes depend on tensor values."""
    tagger = _LoopTagger()
    try:
        with loops.capture_loops(tagger):
            gm = make_fx(torch.func.functionalize(fn, remove="mutations"),
                         tracing_mode="fake", _allow_non_fake_inputs=True)(
                             *args)
    except Exception as e:  # noqa: BLE001 — only data-dependence is renamed
        if not _data_dependent(e):
            raise
        first = str(e).strip().splitlines()[0] if str(e).strip() else ""
        raise ValueError(
            "capture met a data-dependent guard (aten._local_scalar_dense: "
            f"bool() or a Python branch on a tensor's value): {first}") from e
    for n in gm.graph.nodes:
        if _op(n) == "_local_scalar_dense":
            raise ValueError("capture met a data-dependent value "
                             "(aten._local_scalar_dense: .item() of a "
                             f"tensor) at node {n.name}")
        v = _val(n)
        if v is not None and not all(isinstance(d, int) for d in v.shape):
            raise ValueError(f"capture met a data-dependent shape "
                             f"(aten.{_op(n)}) at node {n.name}")
    gm.graph.eliminate_dead_code()
    gm.recompile()
    return gm, tagger.stmts


# ---------------------------------------------------------------------------
# Enumerator: the graph walk
# ---------------------------------------------------------------------------
@dataclass
class _Graph:
    """One graph (the root or a cond/while subgraph) and what the
    recognizers and the binder share about it."""
    gm: fx.GraphModule
    path: tuple                              # enclosing container kinds
    nodes: list = field(default_factory=list)
    index: dict = field(default_factory=dict)        # node -> position
    node_children: dict = field(default_factory=dict)  # node -> [graph ids]
    stmt_nodes: dict = field(default_factory=dict)   # stmt -> [nodes]


class _Ctx:
    """The captured program: root graph, every reachable subgraph, and the
    loop statements.  Holds the GraphModule, so node keys stay valid for
    the lifetime of any program built from it."""

    def __init__(self, gm: fx.GraphModule, stmts: list):
        self.gm = gm
        self.stmts = stmts
        self.graphs: dict[int, _Graph] = {}
        self.order: list[int] = []
        self.root = id(gm.graph)
        self._register(gm, ())
        self.kids: dict[tuple, list] = {}        # (stmt, k) -> [stmts]
        for s in stmts:
            if s.parent is not None:
                self.kids.setdefault(s.parent, []).append(s.id)

    def _register(self, gm, path):
        gid = id(gm.graph)
        if gid in self.graphs:
            return
        g = _Graph(gm, path)
        g.nodes = list(gm.graph.nodes)
        g.index = {n: i for i, n in enumerate(g.nodes)}
        for n in g.nodes:
            for stmt, _ in _frames(n):
                g.stmt_nodes.setdefault(stmt, []).append(n)
        self.graphs[gid] = g
        self.order.append(gid)
        for n in g.nodes:
            kind = _op(n)
            if kind not in ("cond", "while_loop"):
                continue
            subs = [getattr(gm, a.target) for a in n.args
                    if isinstance(a, fx.Node) and a.op == "get_attr"
                    and isinstance(getattr(gm, a.target), fx.GraphModule)]
            g.node_children[n] = [id(s.graph) for s in subs]
            for s in subs:
                self._register(s, path + ("while" if kind == "while_loop"
                                          else kind,))

    def census(self) -> list:
        """The loop statements of one run with every body run once at its
        first iteration — what ``intensity.count_loops`` counts."""
        counted: set = set()
        for s in self.stmts:                 # parents open before children
            if s.parent is None or (s.parent[1] == 0
                                    and s.parent[0] in counted):
                counted.add(s.id)
        return [s for s in self.stmts if s.id in counted]

    # -- loop-statement views -------------------------------------------
    def inside(self, n, stmt: int) -> bool:
        return any(f[0] == stmt for f in _frames(n))

    def nested(self, n, stmt: int) -> bool:
        """n lies in a loop statement nested inside ``stmt``."""
        fr = _frames(n)
        return any(f[0] == stmt for f in fr[:-1])

    def body(self, gid: int, stmt: int, k: int = 0) -> list:
        """Nodes of iteration k of ``stmt`` outside any nested loop."""
        return [n for n in self.graphs[gid].stmt_nodes.get(stmt, ())
                if _frames(n)[-1] == (stmt, k)]

    def sources(self, v, stmt: int, stop=()) -> set:
        """Nodes outside ``stmt`` that ``v`` reads, walking back through
        the statement's own nodes."""
        out, seen, stack = set(), set(), [v]
        while stack:
            cur = stack.pop()
            if not isinstance(cur, fx.Node) or cur in seen or cur in stop:
                continue
            seen.add(cur)
            if cur.op == "get_attr":
                continue
            if not self.inside(cur, stmt):
                out.add(cur)
                continue
            stack.extend(cur.all_input_nodes)
        return out

    def outputs(self, gid: int, stmt: int) -> list:
        """The statement's nodes read after it (its results)."""
        return [n for n in self.graphs[gid].stmt_nodes.get(stmt, ())
                if any(not self.inside(u, stmt) for u in n.users)]


@dataclass
class CandidateSite:
    """One enumerator hit — the analogue of a paper 'loop statement'."""
    kind: str   # "loop" | "while" | "norm" | "gate" | "act" | "conv" | "route"
    path: tuple         # enclosing container kinds from the root
    node_index: int
    primitive: str


_ANCHORS = {"rsqrt": "norm", "silu": "gate", "sigmoid": "gate", "tanh": "act",
            "gelu": "act", "convolution": "conv", "topk": "route",
            "sort": "route"}


def enumerate_sites(ctx: _Ctx) -> list[CandidateSite]:
    """All candidate anchors: the loop statements of the census, while
    loops, and the norm/gate/activation/conv/routing ops."""
    sites = []
    census = {s.id for s in ctx.census()}
    for gid in ctx.order:
        g = ctx.graphs[gid]
        for stmt, nodes in g.stmt_nodes.items():
            if stmt in census:
                sites.append(CandidateSite("loop", g.path, g.index[nodes[0]],
                                           "fori_loop"))
        for i, n in enumerate(g.nodes):
            name = _op(n)
            if name == "while_loop":
                sites.append(CandidateSite("while", g.path, i, name))
            elif name in _ANCHORS:
                sites.append(CandidateSite(_ANCHORS[name], g.path, i, name))
    return sites


# ---------------------------------------------------------------------------
# Node-chasing utilities
# ---------------------------------------------------------------------------
def _peel(v, allowed):
    """Follow ``v`` back through producers whose op is in ``allowed``.
    ``mul``/``div``/``add``/``sub`` are followed through their non-scalar
    operand."""
    while isinstance(v, fx.Node):
        name = _op(v)
        if name not in allowed:
            return v
        if name in ("mul", "div", "add", "sub"):
            a, b = v.args[0], v.args[1]
            if _is_scalar(b) and isinstance(a, fx.Node):
                v = a
            elif name in ("mul", "add") and _is_scalar(a) \
                    and isinstance(b, fx.Node):
                v = b
            else:
                return v
            continue
        v = v.args[0]
    return v


def _forward(v, allowed, want_shape, limit: int = 12):
    """Follow single-consumer layout chains forward until the node has
    ``want_shape``.  Returns the node or None."""
    for _ in range(limit):
        if _shape(v) == tuple(want_shape):
            return v
        users = list(v.users)
        if len(users) != 1 or _op(users[0]) not in allowed \
                or users[0].args[0] is not v:
            return None
        v = users[0]
    return None


def _slice_from(outs, stops):
    """Backward slice: the nodes reachable from ``outs`` stopping at
    ``stops``, and the free leaves (program inputs) beyond them.
    Constants (``get_attr``) are neither: like a jaxpr's constvars, the
    region reads them where it runs."""
    covered, leaves, stack = set(), [], list(outs)
    stops = set(stops)
    while stack:
        v = stack.pop()
        if not isinstance(v, fx.Node) or v in stops or v in covered:
            continue
        if v.op == "get_attr":
            continue
        if v.op == "placeholder":
            if v not in leaves:
                leaves.append(v)
            continue
        covered.add(v)
        stack.extend(v.all_input_nodes)
    return covered, leaves


# ---------------------------------------------------------------------------
# Matches
# ---------------------------------------------------------------------------
@dataclass
class RegionMatch:
    """One recognized block: where it lives, what the variant call binds.

    ``invars``/``outvars`` are nodes of the graph ``graph_id`` points to;
    ``covered`` the nodes the region replaces; ``static_kwargs`` the
    variant's compile-time knobs (e.g. ``causal``/``window``/``eps``)."""
    family: str
    graph_id: int
    path: tuple
    invars: tuple = ()
    outvars: tuple = ()
    covered: frozenset = frozenset()
    static_kwargs: dict = field(default_factory=dict)
    legal: bool = True
    reason: str = ""
    analysis: Optional[RegionAnalysis] = None

    def arg_shapes(self) -> list[str]:
        return [f"{_dtype(v)}{list(_shape(v))}" for v in self.invars]


@dataclass
class Rejection:
    """A structured near-miss: a candidate site that looked like ``family``
    but failed a recognizer precondition, a legality gate, or a stitching
    check.  ``stage`` says which layer said no; ``reason`` is the
    human-readable diagnostic ``--explain`` renders."""
    family: str
    path: tuple
    reason: str
    primitive: str = ""
    node_index: int = -1
    stage: str = "recognizer"        # recognizer | legality | stitch


@dataclass
class ExtractionReport:
    """What the static pass found (before and after legality)."""
    name: str
    sites: list = field(default_factory=list)
    matches: list = field(default_factory=list)     # every RegionMatch
    rejections: list = field(default_factory=list)  # every Rejection
    loop_count: int = 0
    graph_module: Optional[fx.GraphModule] = field(default=None, repr=False)

    @property
    def legal_matches(self) -> list:
        return [m for m in self.matches if m.legal]

    @property
    def families(self) -> list[str]:
        seen = []
        for m in self.legal_matches:
            if m.family not in seen:
                seen.append(m.family)
        return seen

    def summary(self) -> str:
        lines = [f"extract[{self.name}]: {len(self.sites)} candidate sites, "
                 f"{self.loop_count} loops, "
                 f"{len(self.legal_matches)}/{len(self.matches)} legal matches, "
                 f"{len(self.rejections)} rejections"]
        for m in self.matches:
            mark = "+" if m.legal else "-"
            why = "" if m.legal else f"  [{m.reason}]"
            lines.append(f"  {mark} {m.family} @depth{len(m.path)} "
                         f"args={m.arg_shapes()}{why}")
        for r in self.rejections:
            at = f" @{r.primitive}" if r.primitive else ""
            lines.append(f"  ! {r.family} @depth{len(r.path)}{at} "
                         f"[{r.stage}] {r.reason}")
        return "\n".join(lines)


def _node_path(ctx: _Ctx, gid: int, n) -> tuple:
    return ctx.graphs[gid].path + ("fori_loop",) * len(_frames(n))


def _stmt_path(ctx: _Ctx, gid: int, stmt: int) -> tuple:
    return ctx.graphs[gid].path + ("fori_loop",) * ctx.stmts[stmt].depth


# ---------------------------------------------------------------------------
# Recognizer: rmsnorm
# ---------------------------------------------------------------------------
def _producer(v, name: str):
    return v if isinstance(v, fx.Node) and _op(v) == name else None


def _sole_user(v, name: str):
    hits = [u for u in v.users if _op(u) == name]
    return hits[0] if len(hits) == 1 else None


def _match_rmsnorm(ctx: _Ctx, gid: int, n) -> Optional[RegionMatch]:
    """``layers.rms_norm`` in aten: ``_to_copy(x) -> mul(xf, xf) ->
    mean.dim(-1, keepdim) -> add(eps) -> rsqrt -> mul(xf, .) ->
    mul(., add(_to_copy(w), 1.0)) -> _to_copy``, anchored at the rsqrt."""
    if _op(n) != "rsqrt":
        return None
    add = _producer(n.args[0], "add")
    if add is None:
        return None
    eps = mean_v = None
    for a, b in (add.args[:2], add.args[1::-1]):
        if isinstance(b, (int, float)) and isinstance(a, fx.Node):
            eps, mean_v = float(b), a
    mean = _producer(mean_v, "mean")
    if eps is None or mean is None:
        return None
    sq = _producer(mean.args[0], "mul")
    if sq is None or sq.args[0] is not sq.args[1]:
        return None
    xf = sq.args[0]
    x = _peel(xf, ("_to_copy",))
    dims = mean.args[1] if len(mean.args) > 1 else None
    if _shape(x) == () or list(dims or ()) not in ([-1], [len(_shape(x)) - 1]):
        return None
    # forward: rsqrt * xf, then * (1 + w), then the cast back to x's type
    m1 = _sole_user(n, "mul")
    if m1 is None:
        return None
    m2 = _sole_user(m1, "mul")
    if m2 is None:
        return None
    scale = m2.args[1] if m2.args[0] is m1 else m2.args[0]
    w = _peel(scale, ("_to_copy", "add", "expand", "view", "unsqueeze"))
    if len(_shape(w)) != 1 or _shape(w)[0] != _shape(x)[-1]:
        return None
    out = m2
    users = list(out.users)
    if len(users) == 1 and _op(users[0]) == "_to_copy" \
            and _dtype(users[0]) == _dtype(x):
        out = users[0]
    covered, leaves = _slice_from([out], [x, w])
    if leaves:
        return None
    return RegionMatch("rmsnorm", gid, _node_path(ctx, gid, n), (x, w),
                       (out,), frozenset(covered), {"eps": eps})


# ---------------------------------------------------------------------------
# Recognizer: chunked online-softmax attention
# ---------------------------------------------------------------------------
def _match_attention(ctx: _Ctx, gid: int, stmt: int) -> Optional[RegionMatch]:
    """The query-chunk loop of ``layers.chunked_attention``: one nested
    key-chunk loop whose body has the two matmuls, ``exp`` and ``amax`` of
    an online softmax.  q is read per query chunk, k and v inside the key
    loop; the prologue (pad to whole chunks, reshape to the chunk grid) is
    peeled to recover the [B, H, S, D] operands."""
    kids = ctx.kids.get((stmt, 0), [])
    if len(kids) != 1:
        return None
    body = ctx.body(gid, kids[0])
    ops = [_op(n) for n in body]
    mms = [n for n in body if _op(n) in _MATMUL]
    if len(mms) != 2 or "exp" not in ops or "amax" not in ops:
        return None
    s_mm, pv_mm = mms

    def srcs(mm):
        return set().union(*(ctx.sources(a, stmt) for a in mm.args[:2]))

    s_src, pv_src = srcs(s_mm), srcs(pv_mm)
    # k and v are sliced inside the key loop, q once per query chunk
    sliced = {e for e in s_src | pv_src
              if any(ctx.nested(u, stmt) for u in e.users)}
    q_in, k_in = s_src - sliced, s_src & sliced
    v_in = (pv_src & sliced) - k_in
    if len(q_in) != 1 or len(k_in) != 1 or len(v_in) != 1:
        return None
    prologue = ("view", "_unsafe_view", "reshape", "constant_pad_nd")
    q, k, v = (_peel(next(iter(s)), prologue) for s in (q_in, k_in, v_in))
    qs, ks, vs = _shape(q), _shape(k), _shape(v)
    if len(qs) != 4 or len(ks) != 4 or vs != ks:
        return None
    if qs[0] != ks[0] or qs[3] != ks[3] or qs[1] % max(ks[1], 1):
        return None
    ys = ctx.outputs(gid, stmt)
    if len(ys) != 1:
        return None
    out = _forward(ys[0], _LAYOUT, qs)
    if out is None:
        return None

    causal = "le" in ops
    window = 0
    if "gt" in ops:
        lits = sorted({int(n.args[1]) for n in body
                       if _op(n) == "sub" and isinstance(n.args[1], int)
                       and "int" in _dtype(n.args[0])})
        if not lits:
            return None            # windowed mask we can't parameterize
        window = lits[-1]
    covered, leaves = _slice_from([out], [q, k, v])
    if leaves:
        return None
    return RegionMatch("attn_core", gid, _stmt_path(ctx, gid, stmt),
                       (q, k, v), (out,), frozenset(covered),
                       {"causal": causal, "window": window})


# ---------------------------------------------------------------------------
# Recognizer: affine-carry scans (SSM / RG-LRU) and FIR tap loops
# ---------------------------------------------------------------------------
def _carry(ctx: _Ctx, gid: int, stmt: int, body: list):
    """(h, update): the one value from outside the statement that its
    iteration 0 feeds, through layout ops and casts only, to a ``mul``
    (affine recurrence) or an ``add`` (accumulator), and that update."""
    in_body = set(body)
    hits = []
    for e in dict.fromkeys(a for n in body for a in n.all_input_nodes
                           if not ctx.inside(a, stmt)):
        if e.op == "get_attr":
            continue
        v = e
        for _ in range(4):
            users = [u for u in v.users if u in in_body]
            if len(users) != 1:
                break
            u = users[0]
            if _op(u) in _CARRY_CHAIN:
                v = u
                continue
            if _op(u) in ("mul", "add"):
                hits.append((e, v, u))
            break
    return hits[0] if len(hits) == 1 else None


def _match_affine_scan(ctx: _Ctx, gid: int, stmt: int) -> Optional[RegionMatch]:
    """``h_t = cum_a * h[:, None] + cum_b`` over chunks (``ssm_scan_ref``,
    ``rglru_scan_ref``); a ``[.., D, N]`` state with a ``c`` contraction
    is the selective scan, a ``[.., D]`` state the RG-LRU.  A carry
    updated by an ``add`` of a product of slices is the FIR tap loop."""
    if ctx.kids.get((stmt, 0)):
        return None                      # nested loops: not this shape
    body = ctx.body(gid, stmt)
    hit = _carry(ctx, gid, stmt, body) if body else None
    if hit is None:
        return None
    h0, hv, upd = hit
    mms = [n for n in body if _op(n) in _MATMUL]
    if _op(upd) == "add":
        return None if mms else _match_fir(ctx, gid, stmt, h0, hv, upd)

    cum_a = upd.args[1] if upd.args[0] is hv else upd.args[0]
    adds = [u for u in upd.users if _op(u) == "add"]
    if len(adds) != 1 or not isinstance(cum_a, fx.Node):
        return None
    add = adds[0]
    cum_b = add.args[1] if add.args[0] is upd else add.args[0]
    a_src = ctx.sources(cum_a, stmt) - {h0}
    b_src = ctx.sources(cum_b, stmt) - a_src - {h0}
    if len(a_src) != 1 or len(b_src) != 1:
        return None
    prologue = ("view", "_unsafe_view", "reshape", "constant_pad_nd",
                "permute", "transpose")
    a_ext, b_ext = next(iter(a_src)), next(iter(b_src))
    a, bx = _peel(a_ext, prologue), _peel(b_ext, prologue)
    outs = ctx.outputs(gid, stmt)
    carry_out = [o for o in outs if _shape(o) == _shape(h0)]
    ys = [o for o in outs if o not in carry_out]

    if mms:                               # SSM: y_t = h_t . c_t
        if len(mms) != 1 or len(_shape(a)) != 4:
            return None
        c_src = set().union(*(ctx.sources(x, stmt) for x in mms[0].args[:2]))
        c_src -= {a_ext, b_ext, h0}
        if len(c_src) != 1:
            return None
        c = _peel(next(iter(c_src)), prologue)
        invars, family = (a, bx, c, h0), "ssm_scan"
    else:                                 # RG-LRU: gated diagonal recurrence
        if len(_shape(a)) != 3:
            return None
        invars, family = (a, bx, h0), "rglru_scan"
    want = _shape(a)[:3]
    found = [y for y in (_forward(o, _LAYOUT, want) for o in ys)
             if y is not None]
    if len(found) != 1 or len(carry_out) > 1:
        return None
    # the variant returns (y, final_state); a final state nobody reads is
    # not bound (the binder zips the outputs)
    outs = (found[0],) + tuple(carry_out)
    covered, leaves = _slice_from(list(outs), list(invars))
    if leaves:
        return None
    return RegionMatch(family, gid, _stmt_path(ctx, gid, stmt), invars, outs,
                       frozenset(covered))


def _match_fir(ctx: _Ctx, gid: int, stmt: int, acc0, hv,
               upd) -> Optional[RegionMatch]:
    """FIR tap loop (``kernels/ref.py::fir_ref``): an accumulator carry,
    ``acc + h[:, j:j+1] * xp[:, k-1-j : k-1-j+n]``."""
    term = upd.args[1] if upd.args[0] is hv else upd.args[0]
    prod = _producer(term, "mul")
    if prod is None:
        return None
    srcs = set().union(*(ctx.sources(a, stmt) for a in prod.args[:2]))
    acc_shape = _shape(acc0)
    # the signal plane is (padded) at least accumulator-width; the tap
    # vector is the narrow one
    x_in = [s for s in srcs if len(_shape(s)) == len(acc_shape)
            and _shape(s)[0] == acc_shape[0]
            and _shape(s)[-1] >= acc_shape[-1]]
    h_in = [s for s in srcs if s not in x_in]
    if len(x_in) != 1 or len(h_in) != 1:
        return None
    x = _peel(x_in[0], ("constant_pad_nd",))
    h = h_in[0]
    outs = [o for o in ctx.outputs(gid, stmt) if _shape(o) == acc_shape]
    if _shape(x) != acc_shape or len(outs) != 1:
        return None
    covered, leaves = _slice_from(outs, [x, h])
    if leaves:
        return None
    return RegionMatch("fir_bank", gid, _stmt_path(ctx, gid, stmt), (x, h),
                       tuple(outs), frozenset(covered))


def _match_affine_while(ctx: _Ctx, gid: int, n) -> Optional[RegionMatch]:
    """A recurrence written with ``while_loop``: recognized, but never
    legal — the trip count is invisible to the planner (paper: loops whose
    iteration count can't be determined are excluded in Step 1)."""
    kids = ctx.graphs[gid].node_children.get(n, [])
    if len(kids) != 2:
        return None
    prims = {_op(b) for b in ctx.graphs[kids[1]].nodes}
    sliced = {"slice", "narrow", "index_select", "index", "gather"} & prims
    if not ({"mul", "add"} <= prims or sliced):
        return None
    family = "ssm_scan" if prims & set(_MATMUL) else "fir_bank" \
        if sliced else "rglru_scan"
    return RegionMatch(family, gid, _node_path(ctx, gid, n), (), (),
                       frozenset(), legal=False,
                       reason="data-dependent trip count (while loop)")


# ---------------------------------------------------------------------------
# Recognizer: SwiGLU MLP
# ---------------------------------------------------------------------------
_ROWS = ("view", "_unsafe_view", "reshape")


def _matmul_of(v):
    """The ``mm`` a value is, up to the row views around it."""
    p = _peel(v, _ROWS)
    return p if _op(p) == "mm" else None


def _match_swiglu(ctx: _Ctx, gid: int, n) -> Optional[RegionMatch]:
    """``layers.swiglu``: ``silu(x @ w_gate) * (x @ w_up) @ w_down`` with
    2-D weights, anchored at the silu; the row views of a [.., D] ``x``
    around each ``mm`` are peeled.  Gates whose input is not a matmul of
    the same ``x`` as the up projection (Mamba's, RG-LRU's) do not match."""
    if _op(n) != "silu":
        return None
    d1 = _matmul_of(n.args[0])
    if d1 is None:
        return None
    x, wg = _peel(d1.args[0], _ROWS), d1.args[1]
    muls = [u for u in n.users if _op(u) == "mul"]
    if len(muls) != 1:
        return None
    m = muls[0]
    d2 = _matmul_of(m.args[1] if m.args[0] is n else m.args[0])
    if d2 is None or _peel(d2.args[0], _ROWS) is not x:
        return None
    wu = d2.args[1]
    reach = [u for u in m.users]
    reach += [uu for u in m.users if _op(u) in _ROWS for uu in u.users]
    d3s = [u for u in reach if _op(u) == "mm" and _peel(u.args[0], _ROWS) is m]
    if len(d3s) != 1:
        return None
    wd = d3s[0].args[1]
    if any(len(_shape(w)) != 2 for w in (wg, wu, wd)):
        return None
    out = _forward(d3s[0], _ROWS, _shape(x)[:-1] + _shape(wd)[1:])
    if out is None:
        return None
    covered, leaves = _slice_from([out], [x, wg, wu, wd])
    if leaves:
        return None
    return RegionMatch("mlp_core", gid, _node_path(ctx, gid, n),
                       (x, wg, wu, wd), (out,), frozenset(covered))


# ---------------------------------------------------------------------------
# Recognizer: gelu MLP (mm -> + bias -> gelu (tanh) -> mm -> + bias)
# ---------------------------------------------------------------------------
# the ops between a bias vector and the add that applies it
_BIAS_CHAIN = ("_to_copy", "expand", "view", "_unsafe_view", "reshape",
               "unsqueeze")


def _tanh_gelu(n) -> bool:
    """``aten.gelu`` in its tanh form, ``jax.nn.gelu``'s default (the erf
    form is another function than the variants compute)."""
    return _op(n) == "gelu" and n.kwargs.get("approximate", "none") == "tanh"


def _bias_add(v, width: int):
    """(the ``add`` that adds a 1-D ``width`` bias to ``v``, the bias) or
    (None, None)."""
    for u in v.users:
        if _op(u) != "add" or len(u.args) != 2:
            continue
        other = u.args[1] if u.args[0] is v else u.args[0]
        b = _peel(other, _BIAS_CHAIN)
        if isinstance(b, fx.Node) and _shape(b) == (width,):
            return u, b
    return None, None


def _upcast_of(v):
    """The operand of a cast to float32 from another type (the offload
    form's ``.float()`` before its float32 product), else ``v``."""
    if _op(v) == "_to_copy" and _dtype(v) == "float32" \
            and _dtype(v.args[0]) != "float32":
        return v.args[0]
    return v


def _match_gelu_mlp(ctx: _Ctx, gid: int, n) -> Optional[RegionMatch]:
    """``layers.gelu_mlp``: ``gelu(x @ w_up + b_up) @ w_down + b_down``
    with 2-D weights and 1-D biases, anchored at the tanh gelu; the row
    views of a [.., D] ``x`` around each ``mm`` and the casts of the
    float32-accumulating form are peeled."""
    if not _tanh_gelu(n):
        return None
    add1 = _producer(_peel(n.args[0], ("_to_copy",)), "add")
    if add1 is None:
        return None
    d1 = b_up = None
    for a, b in (add1.args[:2], add1.args[1::-1]):
        mm = _matmul_of(a) if isinstance(a, fx.Node) else None
        if mm is not None:
            d1, b_up = mm, _peel(b, _BIAS_CHAIN)
            break
    if d1 is None:
        return None
    x = _upcast_of(_peel(d1.args[0], _ROWS))
    w_up = _upcast_of(d1.args[1])
    if len(_shape(w_up)) != 2 or _shape(b_up) != _shape(w_up)[1:]:
        return None
    # forward: the gelu (cast back, as the offload form does) into w_down
    g = n
    users = list(g.users)
    if len(users) == 1 and _op(users[0]) == "_to_copy":
        g = users[0]
    reach = list(g.users) + [uu for u in g.users if _op(u) in _ROWS
                             for uu in u.users]
    d2s = [u for u in reach if _op(u) == "mm" and _peel(u.args[0], _ROWS) is g]
    if len(d2s) != 1:
        return None
    w_down = d2s[0].args[1]
    if len(_shape(w_down)) != 2:
        return None
    h2 = _forward(d2s[0], _ROWS, _shape(x)[:-1] + _shape(w_down)[1:])
    if h2 is None:
        return None
    out, b_down = _bias_add(h2, _shape(w_down)[1])
    if out is None:
        return None
    users = list(out.users)
    if len(users) == 1 and _op(users[0]) == "_to_copy" \
            and _dtype(users[0]) == _dtype(x):
        out = users[0]
    invars = (x, w_up, b_up, w_down, b_down)
    covered, leaves = _slice_from([out], list(invars))
    if leaves:
        return None
    return RegionMatch("mlp_gelu", gid, _node_path(ctx, gid, n), invars,
                       (out,), frozenset(covered))


# ---------------------------------------------------------------------------
# Recognizer: conv stem (convolution + bias + gelu), whisper's audio stem
# ---------------------------------------------------------------------------
def _match_conv_stem(ctx: _Ctx, gid: int, n):
    """``conv_stem``'s ``ref`` in aten: a 1-D ``convolution`` of
    ``transpose(x)`` [B, Cin, W] (``x`` [B, W, Cin]) with ``permute(w,
    [2, 1, 0])`` (``w`` an HIO kernel [K, Cin, Cout]), "SAME" padded (by
    the conv's own padding, a ``constant_pad_nd`` of zeros, or both),
    transposed back (and made contiguous), plus a [Cout] bias (not the
    conv's own: JAX's conv has none), then the tanh gelu.  Returns a
    ``RegionMatch`` with ``stride`` as a static kwarg, a ``Rejection`` for
    a convolution no registered variant serves (2-D, dilated, transposed,
    grouped, another layout or padding), or None when no bias and gelu
    follow."""
    if _op(n) != "convolution":
        return None
    inp, weight, bias = n.args[0], n.args[1], n.args[2]
    stride, padding, dilation, transposed, _, groups = n.args[3:9]
    g = ctx.graphs[gid]

    def rej(reason):
        return Rejection("conv_stem", _node_path(ctx, gid, n), reason,
                         primitive="convolution", node_index=g.index[n])

    if len(_shape(weight)) != 3:
        return rej(f"{len(_shape(weight)) - 2}-D convolution — only 1-D "
                   "(audio) stems are served")
    if transposed:
        return rej("transposed convolution (lhs dilation) — no registered "
                   "kernel serves dilation")
    if any(d != 1 for d in dilation):
        return rej(f"dilated convolution (dilation={list(dilation)}) — no "
                   "registered kernel serves dilation")
    if groups != 1:
        return rej("grouped convolution — no registered kernel serves "
                   "feature groups")
    pad_lo = pad_hi = int(padding[0])
    pad = _producer(inp, "constant_pad_nd")
    if pad is not None:
        lo, hi = pad.args[1]
        if (len(pad.args) > 2 and pad.args[2]) or lo < 0 or hi < 0:
            return rej(f"conv input padded with {pad.args[1:]} — not the "
                       "stem's zero padding")
        pad_lo, pad_hi, inp = pad_lo + lo, pad_hi + hi, pad.args[0]
    tr = inp if _op(inp) in ("transpose", "permute") else None
    perm = _op(weight) == "permute" and list(weight.args[1]) == [2, 1, 0]
    if tr is None or _shape(tr.args[0]) != (_shape(inp)[0], _shape(inp)[2],
                                             _shape(inp)[1]) or not perm:
        return rej("conv layout is not the stem's [B, W, Cin] input and "
                   "HIO kernel (a transposed x, a [2, 1, 0] permute of w)")
    x, w = tr.args[0], weight.args[0]
    k, s = _shape(w)[0], int(stride[0])
    from repro_torch.models.blocks import same_pad   # the variants' rule
    if (pad_lo, pad_hi) != same_pad(_shape(x)[1], k, s)[1:]:
        return rej(f"conv padding ({pad_lo}, {pad_hi}) is not SAME — the "
                   "registered stem variants assume SAME padding")
    # forward: transpose back to [B, W', Cout] (made contiguous), + bias,
    # gelu
    back = _forward(n, ("transpose", "permute"),
                    (_shape(x)[0], _shape(n)[2], _shape(n)[1]))
    if back is None or back is n:
        return None
    users = list(back.users)
    if len(users) == 1 and _op(users[0]) == "clone":
        back = users[0]
    h, b = _bias_add(back, _shape(w)[2])
    if bias is not None or h is None:
        return None
    gelus = [u for u in h.users if _tanh_gelu(u)]
    if len(gelus) != 1:
        return None
    covered, leaves = _slice_from([gelus[0]], [x, w, b])
    if leaves:
        return None
    return RegionMatch("conv_stem", gid, _node_path(ctx, gid, n), (x, w, b),
                       (gelus[0],), frozenset(covered), {"stride": s})


# ---------------------------------------------------------------------------
# Recognizer: capacity-bounded MoE dispatch
# ---------------------------------------------------------------------------
# the ops between a router's product and its top-k (softmax, casts, views)
_ROUTER_CHAIN = ("_softmax", "softmax", "div", "sub", "exp", "amax", "sum",
                 "_to_copy", "mul", "add", "view", "_unsafe_view", "reshape",
                 "transpose", "permute", "alias", "clone")


def _route_top_k(n):
    """(scores, k) of a top-k anchor: ``aten.topk``, or a stable descending
    ``aten.sort`` whose leading k columns are taken (``models/moe.py``'s
    ``top_k``, JAX's tie-break); else None."""
    if _op(n) == "topk":
        return n.args[0], int(n.args[1])
    if _op(n) != "sort" or not n.kwargs.get("descending", False) \
            or not n.kwargs.get("stable", False):
        return None
    ks = {u2.args[3] for u in n.users if _op(u) == "getitem"
          for u2 in u.users if _op(u2) == "slice" and u2.args[2] == 0}
    if len(ks) != 1 or not isinstance(next(iter(ks)), int):
        return None
    return n.args[0], int(next(iter(ks)))


def _back_to_router_mm(v, limit: int = 16):
    """Walk back from the routed probabilities through the softmax chain to
    the router's ``mm``."""
    for _ in range(limit):
        if not isinstance(v, fx.Node):
            return None
        if _op(v) == "mm":
            return v
        if _op(v) not in _ROUTER_CHAIN:
            return None
        v = v.args[0]
    return None


def _reach(start, frames) -> set:
    """Nodes downstream of ``start`` within one loop iteration ``frames``
    (in an unrolled capture, a layer; the JAX recognizer walks one jaxpr
    level)."""
    out, stack = set(), list(start)
    while stack:
        v = stack.pop()
        if v in out or _frames(v) != frames:
            continue
        out.add(v)
        stack.extend(v.users)
    return out


def _consumers(v) -> list:
    """The first nodes past layout ops that ``v`` feeds."""
    hits, stack, seen = [], [v], set()
    while stack:
        cur = stack.pop()
        for u in cur.users:
            if u in seen:
                continue
            seen.add(u)
            if _op(u) in _LAYOUT:
                stack.append(u)
            else:
                hits.append(u)
    return hits


def _match_moe_dispatch(ctx: _Ctx, gid: int, n):
    """Token-choice top-k routing with a static capacity
    (``models/moe.py::moe_dispatch_dense`` in aten): a top-k of the
    softmax of a router ``mm``, three expert ``bmm``s of the SwiGLU shape
    whose weights are routing-independent [E, ., .] stacks, one dense
    combine product back to the tokens, and the capacity bound
    ``lt(queue position, <int literal>)``.  Returns a ``RegionMatch``, a
    ``Rejection`` for a routed block that cannot be bounded statically,
    or None when the anchor is not a router's top-k."""
    top = _route_top_k(n)
    if top is None:
        return None
    scores, k = top
    router = _back_to_router_mm(scores)
    if router is None or len(_shape(router.args[1])) != 2:
        return None                       # not fed by a router product
    x = _peel(router.args[0], ("_to_copy",))
    w_router = _peel(router.args[1], ("_to_copy",))
    num_experts = _shape(w_router)[-1]
    path = _node_path(ctx, gid, n)
    g = ctx.graphs[gid]

    def rej(reason):
        return Rejection("moe_dispatch", path, reason, primitive=_op(n),
                         node_index=g.index[n])

    frames = _frames(n)
    routed = _reach([n], frames)
    from_x = _reach([x], frames)
    # per-expert FFN: bmms whose lhs is routed data and whose rank-3 rhs
    # (an [E, D, F] weight stack) depends on neither routing nor tokens
    expert = [e for e in g.nodes if _op(e) == "bmm" and e in routed
              and len(_shape(e.args[1])) == 3
              and _shape(e.args[1])[0] == num_experts
              and isinstance(e.args[0], fx.Node) and e.args[0] in routed
              and e.args[1] not in routed and e.args[1] not in from_x]
    if len(expert) != 3:
        return rej("routing found but no per-expert FFN "
                   f"({len(expert)} expert matmuls, expected 3)")
    # gate -> silu -> (* up) = h -> down
    silus = {e: [u for u in _consumers(e) if _op(u) == "silu"] for e in expert}
    gate = [e for e in expert if len(silus[e]) == 1]
    hs = {u for e in gate for u in _consumers(silus[e][0]) if _op(u) == "mul"}
    down = [e for e in expert if _peel(e.args[0], _LAYOUT) in hs]
    up = [e for e in expert if e not in gate and e not in down]
    if len(gate) != 1 or len(down) != 1 or len(up) != 1:
        return rej("per-expert FFN is not the swiglu shape "
                   "(gate/up/down matmuls not identified)")
    w_gate, w_up, w_down = (_peel(e[0].args[1], _LAYOUT)
                            for e in (gate, up, down))
    # combine: the experts' outputs brought back to the tokens by one more
    # dense product
    combines = [u for u in _consumers(down[0]) if _op(u) in _MATMUL]
    if len(combines) != 1:
        return rej("data-dependent MoE routing (scatter/gather combine) — "
                   "no dense combine einsum to bound statically")
    out = _forward(combines[0], _LAYOUT, _shape(x))
    if out is None:
        return None
    users = list(out.users)
    if len(users) == 1 and _op(users[0]) == "_to_copy" \
            and _dtype(users[0]) == _dtype(x):
        out = users[0]
    invars = (x, w_router, w_gate, w_up, w_down)
    covered, leaves = _slice_from([out], list(invars))
    if leaves:
        return None
    # capacity bound: each token's queue position compared with a
    # compile-time int (keep = pos_in_expert < c); without it the routed
    # block has no static shape and cannot be offloaded
    caps = [int(c.args[1]) for c in covered if _op(c) == "lt"
            and isinstance(c.args[1], int) and "int" in _dtype(c.args[0])]
    if not caps:
        return rej("data-dependent MoE routing without a capacity bound — "
                   "token queues have no static size")
    return RegionMatch("moe_dispatch", gid, path, invars, (out,),
                       frozenset(covered),
                       {"num_experts": int(num_experts), "k": k,
                        "capacity": max(caps)})


# ---------------------------------------------------------------------------
# Legality analyzer
# ---------------------------------------------------------------------------
def _mutating(n) -> bool:
    schema = getattr(n.target, "_schema", None)
    return n.op == "call_function" and schema is not None and schema.is_mutable


def _side_effect(n, covered, limit: int = 256) -> str:
    """The mutation of a program input that a covered value ``n`` reaches
    outside the region (the write of a logged value into an input buffer,
    which functionalization keeps as a final ``copy_``), or ""."""
    seen, stack = set(), [u for u in n.users if u not in covered]
    while stack and len(seen) < limit:
        u = stack.pop()
        if u in seen:
            continue
        seen.add(u)
        if _mutating(u):
            return _op(u)
        stack.extend(u.users)
    return ""


def _legalize(ctx: _Ctx, m: RegionMatch) -> RegionMatch:
    if not m.legal:
        return m
    g = ctx.graphs[m.graph_id]

    def fail(reason):
        m.legal, m.reason = False, reason
        return m

    if "while" in m.path:
        return fail("data-dependent trip count (inside while loop)")
    if "cond" in m.path:
        return fail("conditionally executed (inside cond branch)")
    outs = set(m.outvars)
    body = sorted(m.covered, key=g.index.__getitem__)
    for n in body:
        effect = "" if n in outs else _side_effect(n, m.covered)
        if effect:
            return fail(f"side effects in region ({effect})")
    # escape analysis: covered intermediates must stay inside the region
    for n in body:
        if n in outs:
            continue
        for u in n.users:
            if u.op == "output":
                return fail("intermediate value escapes to program outputs")
            if u not in m.covered:
                return fail("intermediate value escapes region "
                            f"(consumed by {_op(u)})")
    # dtype gates: the registered kernels' supported input types
    ok = _FIR_OK if m.family == "fir_bank" else _FLOAT_OK
    for v in m.invars:
        dt = _dtype(v)
        if dt not in ok and not ("int" in dt and m.family == "fir_bank"):
            return fail(f"unsupported dtype {dt} for {m.family}")
    fam = REGISTRY.get(m.family, {})
    if not [v for v in fam if v != "ref"]:
        return fail(f"no offload variants registered for {m.family}")
    # intensity / alignment numbers for the Step-2 ranking
    try:
        args = [meta(_shape(v), _val(v).dtype) for v in m.invars]
        m.analysis = analyze_region(_region_fn(ctx, m), *args, name=m.family)
    except Exception as e:  # noqa: BLE001 — a slice that does not run
        return fail(f"region slice does not trace: {type(e).__name__}: {e}")
    return m


# ---------------------------------------------------------------------------
# Binder: sliced ref callable + the rewritten program
# ---------------------------------------------------------------------------
def _constant(gm: fx.GraphModule, target: str, on_meta: bool):
    v = gm
    for part in target.split("."):
        v = getattr(v, part)
    if on_meta and isinstance(v, torch.Tensor) and not v.is_meta:
        v = torch.empty(v.shape, dtype=v.dtype, device="meta")
    return v


def _call(target, args, kwargs, on_meta: bool):
    """``target(*args, **kwargs)``; on meta arguments, the tensors the op
    creates go to the meta device too."""
    if on_meta and "device" in kwargs:
        kwargs = {**kwargs, "device": torch.device("meta")}
    return target(*args, **kwargs)


class _OnMeta(fx.Interpreter):
    """Runs a captured graph on meta arguments: its constants and the
    tensors it creates become meta too (Step 1's count)."""

    def get_attr(self, target, args, kwargs):
        return _constant(self.module, target, True)

    def call_function(self, target, args, kwargs):
        return _call(target, args, kwargs, True)


def _region_fn(ctx: _Ctx, m: RegionMatch) -> Callable:
    """The match's covered nodes as a standalone callable — the region's
    ``ref`` implementation with the signature recovered from the graph."""
    g = ctx.graphs[m.graph_id]
    body = sorted(m.covered, key=g.index.__getitem__)

    def fn(*args, **_static):
        on_meta = any(isinstance(a, torch.Tensor) and a.is_meta for a in args)
        env = dict(zip(m.invars, args))

        def read(a):
            if a.op == "get_attr":
                return _constant(g.gm, a.target, on_meta)
            return env[a]

        for n in body:
            n_args, n_kwargs = fx.node.map_arg((n.args, n.kwargs), read)
            env[n] = _call(n.target, n_args, n_kwargs, on_meta)
        outs = [env[v] for v in m.outvars]
        return outs[0] if len(outs) == 1 else tuple(outs)

    fn.__name__ = f"extracted_{m.family.replace('+', '_')}"
    return fn


def _coerce(val, spec):
    """Variant outputs may drift in shape or dtype (e.g. an f32-accumulating
    offload variant); pin them back to the graph's recorded ones."""
    shape, dtype = spec
    if tuple(val.shape) != shape:
        val = val.reshape(shape)
    if val.dtype != dtype:
        val = val.to(dtype)
    return val


def _region_call(m: RegionMatch, impl: Impl) -> Callable:
    specs = [(_shape(v), _val(v).dtype) for v in m.outvars]

    def call(*args):
        res = dispatch(m.family, impl, *args, **m.static_kwargs)
        res = res if isinstance(res, tuple) else (res,)
        return tuple(_coerce(r, s) for r, s in zip(res, specs))

    call.__name__ = f"region_{m.family.replace('+', '_')}"
    return call


def _substitute(ctx: _Ctx, kept: list, impl: Impl) -> fx.GraphModule:
    """The root graph with each kept match's covered nodes replaced by one
    call of its region, emitted as soon as all its arguments exist."""
    g = ctx.graphs[ctx.root]
    new = fx.Graph()
    env: dict = {}
    skip = set().union(*(m.covered for m in kept))
    pending = list(kept)

    def emit_ready():
        progress = True
        while progress:
            progress = False
            for m in list(pending):
                if all(v in env for v in m.invars):
                    call = new.call_function(_region_call(m, impl),
                                             tuple(env[v] for v in m.invars))
                    for j, v in enumerate(m.outvars):
                        env[v] = new.call_function(operator.getitem, (call, j))
                    pending.remove(m)
                    progress = True

    emit_ready()
    for n in g.nodes:
        if n in skip:
            continue
        env[n] = new.node_copy(n, lambda a: env[a])
        emit_ready()
    if pending:
        raise RuntimeError("extract: a region's arguments are never computed "
                           f"({[m.family for m in pending]})")
    return fx.GraphModule(g.gm, new)


class Program:
    """A built pattern: the captured graph with the pattern's regions
    substituted (``graph_module``).  Called on meta tensors (the planner's
    Step-1 count) it runs with meta constants and announces the captured
    program's loop statements to the counting observer, since the graph
    has no ``fori_loop`` left to run."""

    def __init__(self, graph_module: fx.GraphModule, census: list):
        self.graph_module = graph_module
        self._census = census

    def _announce(self, observer, parent) -> None:
        for s in self._census:
            if s.parent == parent:
                observer.loop(s.trip, lambda s=s: self._announce(
                    observer, (s.id, 0)))

    def __call__(self, *args):
        observer = loops.loop_observer()
        if observer is not None:
            self._announce(observer, None)
        if any(isinstance(a, torch.Tensor) and a.is_meta for a in args):
            out = _OnMeta(self.graph_module).run(*args)
        else:
            out = self.graph_module(*args)
        return out


def _make_build(ctx: _Ctx, matches: list) -> Callable[[Impl], Program]:
    """build(impl): the captured program with every matched region whose
    pick is not ``ref`` routed through ``regions.dispatch``; the largest
    cover wins, so a stitched pick supersedes its halves."""
    census = ctx.census()
    ours = [m for m in matches if m.graph_id == ctx.root]

    def build(impl: Impl) -> Program:
        impl = Impl(dict(impl))
        picked = [m for m in ours if impl.pick(m.family) != "ref"]
        picked.sort(key=lambda m: -len(m.covered))
        kept, used = [], set()
        for m in picked:
            if m.covered & used:
                continue
            used |= m.covered
            kept.append(m)
        if not kept:
            return Program(ctx.gm, census)
        return Program(_substitute(ctx, kept, impl), census)

    return build


# ---------------------------------------------------------------------------
# The pass: enumerate -> recognize -> legalize
# ---------------------------------------------------------------------------
def _ensure_registry() -> None:
    """Import the modules that register the recognizable kernel families
    (lazy: keeps core import-clean of models/apps)."""
    for mod in ("repro_torch.models.blocks", "repro_torch.models.moe",
                "repro_torch.models.ssm", "repro_torch.models.rglru",
                "repro_torch.kernels.ops", "repro_torch.apps.tdfir"):
        importlib.import_module(mod)


# Family -> recognizer entry point; keep it in sync with FAMILIES.
RECOGNIZERS = {
    "attn_core": _match_attention,
    "ssm_scan": _match_affine_scan,
    "rglru_scan": _match_affine_scan,
    "fir_bank": _match_fir,
    "moe_dispatch": _match_moe_dispatch,
    "conv_stem": _match_conv_stem,
    "mlp_gelu": _match_gelu_mlp,
    "mlp_core": _match_swiglu,
    "rmsnorm": _match_rmsnorm,
}


def _find_matches(ctx: _Ctx) -> tuple[list, list]:
    """Run every recognizer pass; returns ``(matches, rejections)``: the
    legalized matches and the near-misses recognizers reported themselves.
    A node (a loop statement: any of its nodes) covered by an earlier match
    is not an anchor again."""
    matches: list[RegionMatch] = []
    rejections: list[Rejection] = []
    claimed: dict[int, set] = {}

    def admit(m):
        if m is None:
            return
        if isinstance(m, Rejection):
            rejections.append(m)
            return
        used = claimed.setdefault(m.graph_id, set())
        if m.covered & used:
            return
        used.update(m.covered)
        matches.append(m)

    for matcher in (_match_attention, _match_affine_scan):
        for gid in ctx.order:
            for stmt, nodes in ctx.graphs[gid].stmt_nodes.items():
                if not set(nodes) & claimed.get(gid, set()):
                    admit(matcher(ctx, gid, stmt))
    for prims, matcher in ((("while_loop",), _match_affine_while),
                           (("topk", "sort"), _match_moe_dispatch),
                           (("convolution",), _match_conv_stem),
                           (("gelu",), _match_gelu_mlp),
                           (("silu",), _match_swiglu),
                           (("rsqrt",), _match_rmsnorm)):
        for gid in ctx.order:
            for n in ctx.graphs[gid].nodes:
                if _op(n) in prims and n not in claimed.get(gid, set()):
                    admit(matcher(ctx, gid, n))
    return [_legalize(ctx, m) for m in matches], rejections


# ---------------------------------------------------------------------------
# Stitching: fuse adjacent legal regions into a single offload unit
# ---------------------------------------------------------------------------
# the order in which a fused region picks each half's implementation
_FUSED_PREFERENCE = ("hopper", "offload", "seq", "ref")


def _register_fused(family: str) -> None:
    """Generic offload variant for a stitched pair: run each half via its
    best registered implementation (``_FUSED_PREFERENCE``), routing the
    boundary values directly."""
    if "offload" in REGISTRY.get(family, {}):
        return

    def fused(*args, left, right, n_left, wiring, left_kwargs, right_kwargs):
        def best(fam):
            fam_variants = REGISTRY.get(fam, {})
            for v in _FUSED_PREFERENCE:
                if v in fam_variants:
                    return fam_variants[v]
            raise KeyError(f"no variant registered for {fam}")
        lres = best(left)(*args[:n_left], **dict(left_kwargs))
        louts = lres if isinstance(lres, tuple) else (lres,)
        rest = args[n_left:]
        rargs = [louts[i] if kind == "out"
                 else args[i] if kind == "larg" else rest[i]
                 for kind, i in wiring]
        return best(right)(*rargs, **dict(right_kwargs))

    fused.__name__ = f"fused_{family.replace('+', '_')}"
    register_variant(family, "offload")(fused)


def _stitch(ctx: _Ctx, matches: list):
    """Producer/consumer-adjacent legal matches in the same graph emit an
    additional *fused* RegionMatch spanning both node sets.  The fused
    region is a first-class variant: the planner measures it against the
    split form, and its presence re-keys the plan cache."""
    fused: list[RegionMatch] = []
    rejections: list[Rejection] = []
    base = [m for m in matches if m.legal and "+" not in m.family]
    for m1 in base:
        out_pos = {v: i for i, v in enumerate(m1.outvars)}
        for m2 in base:
            if m1 is m2 or m1.graph_id != m2.graph_id:
                continue
            if not any(v in out_pos for v in m2.invars):
                continue                  # not adjacent
            if m1.covered & m2.covered:
                continue
            # no m1 input may be produced inside m2 (would be a cycle)
            if any(v in m2.covered for v in m1.invars):
                continue
            family = f"{m1.family}+{m2.family}"
            # fusion legality: the boundary must be internal to the pair
            union = m1.covered | m2.covered
            if any(u.op == "output" or u not in union
                   for v in m1.outvars for u in v.users):
                rejections.append(Rejection(
                    family, m1.path,
                    "fusion illegal: boundary value escapes the fused "
                    "region", stage="stitch"))
                continue
            larg_pos = {v: i for i, v in enumerate(m1.invars)}
            wiring, extra = [], []
            for v in m2.invars:
                if v in out_pos:
                    wiring.append(("out", out_pos[v]))
                elif v in larg_pos:
                    wiring.append(("larg", larg_pos[v]))
                else:
                    wiring.append(("arg", len(extra)))
                    extra.append(v)
            fm = RegionMatch(
                family, m1.graph_id, m1.path,
                tuple(m1.invars) + tuple(extra), tuple(m2.outvars),
                frozenset(union),
                {"left": m1.family, "right": m2.family,
                 "n_left": len(m1.invars),
                 "wiring": tuple(wiring),
                 "left_kwargs": dict(m1.static_kwargs),
                 "right_kwargs": dict(m2.static_kwargs)})
            _register_fused(family)
            fused.append(_legalize(ctx, fm))
    return fused, rejections


def extract(fn: Callable, args: tuple, *, name: str = "program"
            ) -> ExtractionReport:
    """Run the static pass only: capture ``fn(*args)``, enumerate candidate
    sites, and return every recognizer match with its legality verdict.
    ``args`` may be concrete, meta or fake tensors.  ``report.graph_module``
    is the captured graph."""
    _ensure_registry()
    gm, stmts = capture(fn, args)
    ctx = _Ctx(gm, stmts)
    report = ExtractionReport(name=name)
    report.sites = enumerate_sites(ctx)
    report.loop_count = len(ctx.census()) + sum(
        1 for s in report.sites if s.kind == "while")
    matches, rrejs = _find_matches(ctx)
    stitched, srejs = _stitch(ctx, matches)
    report.matches = matches + stitched
    report.rejections = rrejs + srejs + [
        Rejection(m.family, m.path, m.reason, stage="legality")
        for m in matches if not m.legal]
    report.graph_module = gm
    report._ctx = ctx                     # keeps node keys alive
    return report


def _concrete(a) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return (isinstance(a, torch.Tensor) and not a.is_meta
            and not isinstance(a, FakeTensor))


def discover(fn: Callable, args: tuple, *, name: str = "discovered",
             sample_inputs: Optional[Callable] = None,
             families: Optional[tuple] = None) -> OffloadableProgram:
    """Turn an *unannotated* function into a planner-ready program.

    Captures ``fn(*args)``, recognizes offloadable blocks, and returns an
    ``OffloadableProgram`` whose regions are the legal matches (one region
    per kernel family — picking a variant re-routes **every** match of
    that family, exactly like the annotated dispatch path) and whose
    ``build(impl)`` rewrites the captured graph with the chosen variants
    substituted.  No ``register_variant`` / ``Region`` annotations are
    needed in the program's own definition.

    The program runs on the device of ``args``.  ``sample_inputs``
    defaults to replaying the (concrete) capture ``args`` for every
    measurement; pass a callable ``(seed, device) -> args`` to randomize
    (it must give the captured shapes).  ``families`` optionally restricts
    which kernel families become regions."""
    report = extract(fn, args, name=name)
    ctx = report._ctx
    picked: dict[str, list] = {}
    for m in report.legal_matches:
        if families and m.family not in families:
            continue
        picked.setdefault(m.family, []).append(m)
    regions = []
    for family, ms in picked.items():
        rep = max(ms, key=lambda m: m.analysis.flops if m.analysis else 0.0)
        fam_variants = REGISTRY.get(family, {})
        deploy = "hopper" if "hopper" in fam_variants else "offload"
        # measurement-variant parity with the annotated path: a sequential
        # fallback (ssm) is the cheap-to-time proxy when one is registered
        measure = ("seq" if "seq" in fam_variants
                   else ("offload" if "offload" in fam_variants else deploy))
        regions.append(Region(
            name=family,
            analysis_fn=_region_fn(ctx, rep),
            analysis_args=tuple(meta(_shape(v), _val(v).dtype)
                                for v in rep.invars),
            measure_variant=measure,
            deploy_variant=deploy,
            static_kwargs=dict(rep.static_kwargs)))
    build = _make_build(ctx, [m for ms in picked.values() for m in ms])

    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if sample_inputs is None:
        if not all(_concrete(a) for a in tensors):
            raise ValueError("discover() needs concrete capture args or an "
                             "explicit sample_inputs callable")
        def sample_inputs(seed, device, _args=tuple(args)):
            return _args
    device = tensors[0].device if tensors else torch.device("cpu")

    prog = OffloadableProgram(
        name=f"extract:{name}",
        regions=regions,
        build=build,
        sample_inputs=sample_inputs,
        device=device,
        source_loop_count=report.loop_count,
        description="regions discovered by static extraction over a "
                    "captured aten graph",
        cache_extra={
            "extractor": 1,
            "inputs": [f"{_dtype_of(a)}{list(getattr(a, 'shape', ()))}"
                       for a in args],
        })
    prog.extraction = report              # diagnostics for launchers/tests
    return prog


def _dtype_of(a) -> str:
    dt = getattr(a, "dtype", None)
    return (str(dt).removeprefix("torch.") if dt is not None
            else type(a).__name__)
