"""Flash attention (causal / sliding-window prefill, GQA) — wrapper of the
hand-written CUDA kernel ``csrc/flash_attention.cu``.

:func:`flash_attention` launches the kernel on CUDA tensors and runs
:func:`flash_attention_plain`, the same function in plain PyTorch, on CPU
or meta tensors.  On a CUDA tensor it launches or raises; it never falls
back.  ``block_q`` / ``block_k`` are the kernel's tile sizes; S need not be
a multiple of either (the kernel masks its ragged last tiles).  One C entry
point serves two bodies: bf16 runs on the tensor cores (``wgmma`` fed by
TMA, tiles kept bf16 in shared memory, ``block_q`` and ``block_k`` in
{64, 128}); float32 runs on them too, as split-TF32 (3xTF32) ``wgmma``
products: each operand is cut into a TF32 high and low part and a.b is
taken as hi.hi + hi.lo + lo.hi in float32 (the producer warpgroup splits
K and V, transposed, into shared memory; the consumers split Q and P in
registers), ``block_q`` in {64, 128} and ``block_k`` in {32, 64}.

bf16 work units (split-KV): :func:`split_plan` cuts the kv tiles a q tile
visits into contiguous chunks where one block a q tile would leave SMs idle
(a few heads over a short or causal sequence); a chunk of a split tile
writes float32 partials to a workspace allocated here, and
:func:`flash_attention_combine` (a second kernel, counted by its own
``launches``) sums each row's chunks into o.  The C source computes the
same plan, and :func:`_lib` holds the two equal.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import heapq
import itertools
import math

import torch

from repro_torch.kernels import SMEM_PER_BLOCK, _build

NEG_INF = -1e30
BLOCK_QS = (32, 64, 128)         # query rows per block (the tuning axis)
BLOCK_KS = (32, 64, 128)         # keys per shared-memory tile
HEAD_DIMS = (16, 32, 64, 128, 256)   # head widths the source instantiates
WGMMA_BLOCK_QS = (64, 128)       # bf16: one consumer warpgroup per 64 rows
WGMMA_BLOCK_KS = (64, 128)       # bf16: the S = Q K^T product's width
STAGES = 2                       # bf16: K/V tiles in the shared-memory ring
# the best bf16 point at [1, 32/8, 2,048, 128] (chip_smoke.py phase 3); a
# call without tiles takes default_tiles(dtype, head_dim)
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
# float32: the (head_dim, block_q, block_k) points csrc builds
# (TF32_INSTANCES): block_k 32 or 64 where the K/V ring and the Q tile fit
# shared memory and the consumers' registers (not 128 x 64 at head_dim 128)
F32_POINTS = frozenset(
    [(d, bq, bk) for d in (16, 32, 64) for bq in (64, 128) for bk in (32, 64)]
    + [(128, 64, 32), (128, 64, 64), (128, 128, 32), (256, 64, 32)])
_ALIGN = 1024                    # room to align the tiles to 1 KB
_BARRIERS = 128                  # the ring's mbarriers
_PRODUCER = 128                  # the producer warpgroup


def _bf16(dtype) -> bool:
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention: no kernel for {dtype}")
    return dtype == torch.bfloat16


def smem_bytes(block_q: int, block_k: int, head_dim: int, dtype) -> int:
    """Dynamic shared memory of one block.  bf16: the Q tile and STAGES K
    and V tiles, all bf16, the barriers and 1 KB of alignment room.
    float32: a ring of two K/V stages where it fits (else one), each the
    hi and lo parts of K and of V transposed, [block_k x D] float32 each;
    the raw Q tile with rows D + 4 floats apart; the same barriers and
    alignment room."""
    if _bf16(dtype):
        return (2 * head_dim * (block_q + 2 * STAGES * block_k) + _ALIGN
                + _BARRIERS)
    rest = 4 * block_q * (head_dim + 4) + _ALIGN + _BARRIERS
    stage = 16 * block_k * head_dim
    return (2 * stage if 2 * stage + rest <= SMEM_PER_BLOCK else stage) + rest


def threads(block_q: int, head_dim: int, dtype) -> int:
    """Threads of one block, either type: a warpgroup (128) per 64 query
    rows and the producer warpgroup."""
    _bf16(dtype)                 # raises for another type
    return block_q // 64 * 128 + _PRODUCER


def fits(block_q: int, block_k: int, head_dim: int, dtype) -> bool:
    """Whether the source instantiates the point for this type and head
    width and the block fits Hopper's shared memory."""
    if head_dim not in HEAD_DIMS or block_k not in BLOCK_KS:
        return False
    if _bf16(dtype):
        return (block_q in WGMMA_BLOCK_QS and block_k in WGMMA_BLOCK_KS
                and smem_bytes(block_q, block_k, head_dim, dtype)
                <= SMEM_PER_BLOCK)
    return ((head_dim, block_q, block_k) in F32_POINTS
            and smem_bytes(block_q, block_k, head_dim, dtype)
            <= SMEM_PER_BLOCK)


def default_tiles(dtype, head_dim: int) -> tuple[int, int]:
    """(block_q, block_k) of a call that names none: the defaults where
    they fit (or where nothing does), else the fitting point with the
    largest tile, the larger block_q first — (128, 64) for bf16 at
    head_dim 256; for float32 (128, 64) up to head_dim 64, (128, 32) at
    128 and (64, 32) at 256."""
    ok = [(bq, bk) for bq, bk in itertools.product(BLOCK_QS, BLOCK_KS)
          if fits(bq, bk, head_dim, dtype)]
    if not ok or (DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K) in ok:
        return DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K
    return max(ok, key=lambda p: (p[0] * p[1], p[0]))


# the bf16 split plan's constants (csrc/flash_attention.cu has the same;
# see split_plan)
SPLIT_MIN_TILES = 2              # no chunk below 2 kv tiles
SPLIT_NO_SPLIT_WAVES = 4         # no split where the q tiles fill 4 waves
SPLIT_MAX_WAVES = 16             # no chunks that make more than 16 waves
SPLIT_COMBINE_NS = 1000          # the combine's cost besides its bytes
SPLIT_BYTES_PER_NS = 2500        # the combine's rate over the partials


def visit_range(qt: int, s: int, block_q: int, block_k: int, causal: bool,
                window: int) -> tuple[int, int]:
    """The kv tiles [begin, end) q tile ``qt`` visits: below the causal
    diagonal, not wholly below the window."""
    q0 = qt * block_q
    n_tiles = -(-s // block_k)
    end = (min(n_tiles, (q0 + block_q + block_k - 1) // block_k) if causal
           else n_tiles)
    begin = ((q0 - window + 1) // block_k if window > 0 and q0 - window + 1 > 0
             else 0)
    return begin, end


def chunk_count(n: int, chunk_tiles: int) -> int:
    """Chunks of a range of ``n`` kv tiles: ceil(n / chunk_tiles), none
    below SPLIT_MIN_TILES tiles; one where chunk_tiles is 0 or n fits."""
    if chunk_tiles <= 0 or n <= chunk_tiles:
        return 1
    return min(-(-n // chunk_tiles), n // SPLIT_MIN_TILES)


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How the bf16 kernel cuts its work: each q tile's kv range into
    :func:`chunk_count` contiguous chunks of at most ``chunk_tiles`` tiles
    (0: one chunk a q tile), one block each."""
    b: int
    hq: int
    s: int
    d: int
    block_q: int
    block_k: int
    causal: bool
    window: int
    chunk_tiles: int

    @functools.cached_property
    def tiles(self) -> tuple:
        """((qt, ((begin, n), ...)), ...): the q tiles in the kernel's unit
        order (the last first) with their chunks' kv tiles [begin, begin +
        n), the first n % chunks one tile longer."""
        out = []
        for qt in range(-(-self.s // self.block_q) - 1, -1, -1):
            begin, end = visit_range(qt, self.s, self.block_q, self.block_k,
                                     self.causal, self.window)
            n = end - begin
            c = chunk_count(n, self.chunk_tiles)
            starts = [begin + i * (n // c) + min(i, n % c) for i in range(c)]
            out.append((qt, tuple((lo, n // c + (i < n % c))
                                  for i, lo in enumerate(starts))))
        return tuple(out)

    @property
    def units(self) -> int:
        """Blocks of one (batch, head)."""
        return sum(len(ch) for _, ch in self.tiles)

    @property
    def partials(self) -> int:
        """Chunks of split q tiles, one (batch, head)."""
        return sum(len(ch) for _, ch in self.tiles if len(ch) > 1)

    @property
    def split_tiles(self) -> int:
        """q tiles cut into more than one chunk, one (batch, head)."""
        return sum(len(ch) > 1 for _, ch in self.tiles)

    @property
    def workspace_floats(self) -> int:
        """float32 words of the partials: [B * Hq][partials][block_q][D]
        accumulators, then [B * Hq][partials][block_q][2] (m, l)."""
        return (self.b * self.hq * self.partials * self.block_q
                * (self.d + 2))


def _schedule_ns(bh: int, sizes: list[int], slots: int, unit_ns: int,
                 tile_ns: int) -> int:
    """The last finish time of a head's units ``sizes`` (kv tiles, in unit
    order) dispatched heads-fastest for ``bh`` heads onto ``slots`` slots,
    each unit to the slot free first."""
    free = [0] * slots                           # a heap
    last = 0
    for n in sizes:
        cost = unit_ns + n * tile_ns
        for _ in range(bh):
            t = free[0] + cost
            heapq.heapreplace(free, t)
            last = max(last, t)
    return last


@functools.lru_cache(maxsize=4096)
def split_plan(b: int, hq: int, s: int, d: int, block_q: int, block_k: int,
               causal: bool, window: int, n_sm: int,
               ctas_per_sm: int = 1) -> SplitPlan:
    """The bf16 kernel's work units for [b, hq, s, d] on ``n_sm`` SMs that
    hold ``ctas_per_sm`` blocks each (``cudaOccupancyMaxActiveBlocksPer
    Multiprocessor`` of the instance, :func:`ctas_per_sm`).

    Blocks are dispatched heads-fastest, so the plan simulates that
    dispatch, each unit to the slot free first: a unit of n kv tiles costs
    250 + block_q * d / 4 ns (its Q tile's load, its output's store) plus
    n tiles of block_q * block_k * (d + 64) / 1500 ns (the products, and
    the softmax as much as 64 columns more), and a split adds the combine,
    SPLIT_COMBINE_NS plus the partials' float32 bytes at
    SPLIT_BYTES_PER_NS.  The constants are a fit to every cut of rows 3,
    3b, 3p and 3w on an H100 (``tools/flash_split_probe.py --sweep``;
    PERF.md §6).  One unit a q tile where the q tiles fill
    SPLIT_NO_SPLIT_WAVES waves of the card; otherwise chunk_tiles falls
    from the longest range down to SPLIT_MIN_TILES while the units stay
    within SPLIT_MAX_WAVES waves, and the least estimate wins (the longer
    chunks on a tie).  Integer arithmetic throughout: csrc's
    ``compute_split_plan`` computes the same."""
    causal, window = bool(causal), int(window)
    bh, slots = b * hq, n_sm * ctas_per_sm
    best = SplitPlan(b, hq, s, d, block_q, block_k, causal, window, 0)
    if bh * best.units >= SPLIT_NO_SPLIT_WAVES * slots:
        return best
    ranges = [n for _, ((_, n),) in best.tiles]  # kv tiles, in unit order
    unit_ns = 250 + block_q * d // 4
    tile_ns = block_q * block_k * (d + 64) // 1500
    best_ns = _schedule_ns(bh, ranges, slots, unit_ns, tile_ns)
    for t in range(max(ranges) - 1, SPLIT_MIN_TILES - 1, -1):
        cut = SplitPlan(b, hq, s, d, block_q, block_k, causal, window, t)
        sizes = [n for _, chunks in cut.tiles for _, n in chunks]
        if bh * len(sizes) > SPLIT_MAX_WAVES * slots:
            break
        if not cut.partials:
            continue
        ns = (_schedule_ns(bh, sizes, slots, unit_ns, tile_ns)
              + SPLIT_COMBINE_NS
              + 4 * cut.workspace_floats // SPLIT_BYTES_PER_NS)
        if ns < best_ns:
            best, best_ns = cut, ns
    return best


def _mask(s: int, causal: bool, window: int, device) -> torch.Tensor:
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window:
        mask = mask & (kpos > qpos - window)
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """Plain PyTorch version with the kernel's precision: float32 scores of
    the float32-scaled q, p = exp(s - row max) rounded to v's type for
    P.V, the row sum taken over the unrounded p, o in q's type."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qg = (q.float() * (1.0 / math.sqrt(d))).reshape(b, hkv, g, s, d)
    sc = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    sc = torch.where(_mask(s, causal, window, q.device), sc, NEG_INF)
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    out = acc / p.sum(dim=-1).clamp_min(1e-30)[..., None]
    return out.reshape(b, hq, s, d).to(q.dtype)


def flash_attention_combine_plain(part: torch.Tensor, plan: SplitPlan,
                                  o: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the combine: ``o`` with each split q tile's
    rows made from its chunks' partials in ``part`` (the kernel's
    workspace layout, :attr:`SplitPlan.workspace_floats`): M = max_c m_c,
    w_c = 2^(m_c - M), o = sum_c w_c acc_c / max(sum_c w_c l_c, 1e-30) in
    float32, in o's type."""
    bh, bq, d, n = plan.b * plan.hq, plan.block_q, plan.d, plan.partials
    acc = part[:bh * n * bq * d].view(bh, n, bq, d)
    ml = part[bh * n * bq * d:plan.workspace_floats].view(bh, n, bq, 2)
    out = o.clone().view(bh, plan.s, d)
    p0 = 0
    for qt, chunks in plan.tiles:
        c = len(chunks)
        if c == 1:
            continue
        rows = min(bq, plan.s - qt * bq)
        m, l = ml[:, p0:p0 + c, :rows, 0], ml[:, p0:p0 + c, :rows, 1]
        w = torch.exp2(m - m.amax(dim=1, keepdim=True))
        num = (w[..., None] * acc[:, p0:p0 + c, :rows]).sum(dim=1)
        den = (w * l).sum(dim=1).clamp_min(1e-30)
        out[:, qt * bq:qt * bq + rows] = (num / den[..., None]).to(o.dtype)
        p0 += c
    return out.view_as(o)


# (B * Hq, S, D) shapes on which _lib() holds the C split plan equal to
# split_plan, at every fitting bf16 tile point, on 132 SMs of 1 and 2
# blocks: rows 3, 3b, 3p and 3w of PERF.md and small ragged, windowed and
# bidirectional ones
_PLAN_CHECKS = ((32, 2048, 128, True, 0), (10, 2048, 256, True, 2048),
                (8, 272, 256, True, 0), (8, 768, 256, True, 0),
                (8, 2080, 256, True, 0), (12, 1500, 64, False, 0),
                (8, 300, 64, True, 70), (4, 100, 16, False, 0),
                (2, 1000, 32, True, 200), (64, 512, 128, True, 0))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll, ip = ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)
    launch = (i, (vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, f, i, i, vp, ll,
                  vp))
    _build.declare(lib, {
        "flash_attention_launch": launch,
        "flash_attention_launch_schedule": launch,
        "flash_attention_combine_launch": (i, (vp, vp, i, i, i, i, i, i, i,
                                               i, i, vp)),
        "flash_attention_split_plan": (i, (i, i, i, i, i, i, i, i, i, ip)),
        "flash_attention_ctas_per_sm": (i, (i, i, i, ip)),
        "flash_attention_attributes": (i, (i, i, i, i, ip, ip, ip)),
        "flash_attention_smem_bytes": (ll, (i, i, i, i)),
        "flash_attention_threads": (i, (i, i, i, i)),
    })
    # every point the tuning space may propose: the C figures equal the
    # Python ones, and the kernels run exactly the fitting points
    for dtype, d, bq, bk in itertools.product(
            (torch.bfloat16, torch.float32), HEAD_DIMS, BLOCK_QS, BLOCK_KS):
        flag = int(dtype == torch.bfloat16)
        c = (lib.flash_attention_smem_bytes(bq, bk, d, flag),
             lib.flash_attention_threads(bq, bk, d, flag))
        agree = c == ((smem_bytes(bq, bk, d, dtype), threads(bq, d, dtype))
                      if fits(bq, bk, d, dtype) else (-1, -1))
        if not agree:
            raise RuntimeError(
                f"csrc/flash_attention.cu and kernels/flash_attention.py "
                f"disagree on the {dtype} block at head_dim {d}, block_q "
                f"{bq}, block_k {bk}: C (smem, threads) {c}")
    # the split plans agree
    out = (ctypes.c_int * 4)()
    for (bh, s, d, causal, window), bq, bk, ctas in itertools.product(
            _PLAN_CHECKS, WGMMA_BLOCK_QS, WGMMA_BLOCK_KS, (1, 2)):
        if not fits(bq, bk, d, torch.bfloat16):
            continue
        _build.check(lib.flash_attention_split_plan(
            bh, s, d, bq, bk, int(causal), window, 132, ctas, out), lib,
            "flash_attention_split_plan")
        p = split_plan(1, bh, s, d, bq, bk, causal, window, 132, ctas)
        py = (p.chunk_tiles, p.units, p.partials, p.split_tiles)
        if tuple(out) != py:
            raise RuntimeError(
                f"csrc/flash_attention.cu and kernels/flash_attention.py "
                f"disagree on the split plan of [{bh}, {s}, {d}] causal="
                f"{causal} window={window} at {bq}x{bk}, {ctas} blocks an "
                f"SM: C {tuple(out)}, Python {py}")
    return lib


@functools.cache
def ctas_per_sm(block_q: int, block_k: int, head_dim: int,
                device_index: int) -> int:
    """Blocks of the bf16 instance an SM of the card holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    lib, n = _lib(), ctypes.c_int()
    with torch.cuda.device(device_index):
        _build.check(lib.flash_attention_ctas_per_sm(
            block_q, block_k, head_dim, ctypes.byref(n)), lib,
            "flash_attention_ctas_per_sm")
    return n.value


def device_plan(device, b: int, hq: int, s: int, d: int, block_q: int,
                block_k: int, causal: bool, window: int) -> SplitPlan:
    """:func:`split_plan` on the card ``device``: its SMs and the blocks of
    the instance an SM holds."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    n_sm = torch.cuda.get_device_properties(index).multi_processor_count
    return split_plan(b, hq, s, d, block_q, block_k, bool(causal),
                      int(window), n_sm,
                      ctas_per_sm(block_q, block_k, d, index))


def kernel_attributes(block_q: int, block_k: int, head_dim: int,
                      dtype) -> dict:
    """``cudaFuncGetAttributes`` of the instance that runs the point (its
    shared memory is dynamic: see :func:`smem_bytes`)."""
    return _build.func_attributes(_lib(), "flash_attention_attributes",
                                  block_q, block_k, head_dim,
                                  int(_bf16(dtype)))


@_build.on_mesh
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: int | None = None,
                    block_k: int | None = None) -> torch.Tensor:
    """q: [B, Hq, S, D]; k/v: [B, Hkv, S, D], Hq a multiple of Hkv; all
    bf16 or all float32, contiguous.  Returns [B, Hq, S, D] in q's type.
    Without tiles it takes :func:`default_tiles` of q's type and D."""
    _build.refuse_grad("flash_attention", "attn_core", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q [B, Hq, S, D] and k/v "
                         f"[B, Hkv, S, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d) or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)} (self-attention, Hq a "
                         "multiple of Hkv)")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: want q, k, v all bfloat16 or all "
                        f"float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: q on {q.device}, k on {k.device}, "
                         f"v on {v.device}")
    if block_q is None or block_k is None:
        dq, dk = default_tiles(q.dtype, d)
        block_q = dq if block_q is None else block_q
        block_k = dk if block_k is None else block_k
    if block_q not in BLOCK_QS or block_k not in BLOCK_KS:
        raise ValueError(f"flash_attention: block_q={block_q} / block_k="
                         f"{block_k} not in {BLOCK_QS} / {BLOCK_KS}")
    if q.numel() == 0:
        raise ValueError("flash_attention: empty input")
    if q.device.type in ("cpu", "meta"):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if not fits(block_q, block_k, d, q.dtype):
        raise ValueError(
            f"flash_attention: head_dim {d} with block_q={block_q}, block_k="
            f"{block_k} in {q.dtype} exceeds the kernel's limits (head_dim in "
            f"{HEAD_DIMS}; bf16: block_q in {WGMMA_BLOCK_QS}, block_k in "
            f"{WGMMA_BLOCK_KS}; float32: (head_dim, block_q, block_k) in "
            f"F32_POINTS; shared memory <= {SMEM_PER_BLOCK} B)")
    if b * hq > 65_535 or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: B * Hq > 65,535 or a pointer not "
                         "16-byte aligned")
    o = torch.empty_like(q)
    lib = _lib()
    bf16 = q.dtype == torch.bfloat16
    plan = (device_plan(q.device, b, hq, s, d, block_q, block_k, causal,
                        window) if bf16 else None)
    # the split chunks' partials (from the graph's pool inside a capture)
    part = (torch.empty(plan.workspace_floats, dtype=torch.float32,
                        device=q.device) if plan and plan.partials else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq,
            hkv, s, d, block_q, block_k, int(causal), int(window),
            1.0 / math.sqrt(d), int(bf16), plan.chunk_tiles if plan else 0,
            part.data_ptr() if part is not None else None,
            part.numel() if part is not None else 0, stream)
    _build.check(code, lib, "flash_attention")
    flash_attention.launches += 1
    if part is not None:
        flash_attention_combine(part, plan, o)
    return o


flash_attention.launches = 0     # kernel launches since the last reset


def flash_attention_combine(part: torch.Tensor, plan: SplitPlan,
                            o: torch.Tensor) -> torch.Tensor:
    """Write o's split q tiles from the partials ``part`` of a bf16 launch
    cut by ``plan`` (``flash_combine_kernel``, on the current stream after
    that launch); returns o.  On a CPU tensor, in place, from
    :func:`flash_attention_combine_plain`."""
    if part.dtype != torch.float32 or part.numel() < plan.workspace_floats \
            or o.shape != (plan.b, plan.hq, plan.s, plan.d) \
            or not (part.is_contiguous() and o.is_contiguous()) \
            or part.device != o.device:
        raise ValueError("flash_attention_combine: want float32 partials of "
                         "the plan's workspace size and o [B, Hq, S, D] of "
                         "the plan, contiguous, on one device")
    if o.device.type in ("cpu", "meta"):
        return o.copy_(flash_attention_combine_plain(part, plan, o))
    if o.device.type != "cuda" or o.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_combine: no kernel for {o.dtype} "
                         f"on {o.device}")
    lib = _lib()
    with torch.cuda.device(o.device):
        code = lib.flash_attention_combine_launch(
            part.data_ptr(), o.data_ptr(), plan.b, plan.hq, plan.s, plan.d,
            plan.block_q, plan.block_k, int(plan.causal), plan.window,
            plan.chunk_tiles, torch.cuda.current_stream(o.device).cuda_stream)
    _build.check(code, lib, "flash_attention_combine")
    flash_attention_combine.launches += 1
    return o


flash_attention_combine.launches = 0    # combine launches since the reset
