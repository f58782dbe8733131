"""Flash attention (causal / sliding-window prefill, GQA) — wrapper of the
hand-written CUDA kernel ``csrc/flash_attention.cu``.

:func:`flash_attention` launches the kernel on CUDA tensors and runs
:func:`flash_attention_plain`, the same function in plain PyTorch, on CPU
or meta tensors.  On a CUDA tensor it launches or raises; it never falls
back.  ``block_q`` / ``block_k`` are the kernel's tile sizes; S need not be
a multiple of either (the kernel masks its ragged last tiles).  One C entry
point serves two bodies: bf16 runs on the tensor cores (``wgmma`` fed by
TMA, tiles kept bf16 in shared memory, ``block_q`` and ``block_k`` in
{64, 128}); float32 runs scalar FP32 FMAs over float32 tiles.
"""
from __future__ import annotations

import ctypes
import functools
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
MAX_THREADS = 256                # float32 body
# the best bf16 point at [1, 32/8, 2,048, 128] (chip_smoke.py phase 3); a
# call without tiles takes default_tiles(dtype, head_dim)
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
_PAD = 4                         # float32: floats of padding per row
_ALIGN = 1024                    # bf16: room to align the tiles to 1 KB
_BARRIERS = 128                  # bf16: the ring's mbarriers
_PRODUCER = 128                  # bf16: the producer warpgroup


def _bf16(dtype) -> bool:
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention: no kernel for {dtype}")
    return dtype == torch.bfloat16


def smem_bytes(block_q: int, block_k: int, head_dim: int, dtype) -> int:
    """Dynamic shared memory of one block.  bf16: the Q tile and STAGES K
    and V tiles, all bf16, the barriers and 1 KB of alignment room.
    float32: the q tile [block_q, D + 4], k and v tiles [block_k, D + 4]
    and the probabilities [block_q, block_k + 1], all float32."""
    if _bf16(dtype):
        return (2 * head_dim * (block_q + 2 * STAGES * block_k) + _ALIGN
                + _BARRIERS)
    ld = head_dim + _PAD
    return 4 * (block_q * ld + 2 * block_k * ld + block_q * (block_k + 1))


def threads(block_q: int, head_dim: int, dtype) -> int:
    """Threads of one block.  bf16: a warpgroup (128) per 64 query rows and
    the producer warpgroup.  float32: 4 query rows per thread, 8 threads per
    row group (16 at head_dim 256, where 8 would need 128 accumulators)."""
    if _bf16(dtype):
        return block_q // 64 * 128 + _PRODUCER
    return block_q // 4 * (16 if head_dim >= 256 else 8)


def fits(block_q: int, block_k: int, head_dim: int, dtype) -> bool:
    """Whether the source instantiates the point for this type and head
    width and the block fits Hopper's shared memory (and, float32, the
    kernel's thread limit)."""
    if head_dim not in HEAD_DIMS or block_k not in BLOCK_KS:
        return False
    if _bf16(dtype):
        return (block_q in WGMMA_BLOCK_QS and block_k in WGMMA_BLOCK_KS
                and smem_bytes(block_q, block_k, head_dim, dtype)
                <= SMEM_PER_BLOCK)
    return (block_q in BLOCK_QS
            and threads(block_q, head_dim, dtype) <= MAX_THREADS
            and smem_bytes(block_q, block_k, head_dim, dtype)
            <= SMEM_PER_BLOCK)


def default_tiles(dtype, head_dim: int) -> tuple[int, int]:
    """(block_q, block_k) of a call that names none: the defaults where
    they fit (or where nothing does), else the fitting point with the
    largest tile, the larger block_q first — (128, 64) for bf16 at
    head_dim 256, (128, 64) and (64, 64) for float32 at 128 and 256."""
    ok = [(bq, bk) for bq, bk in itertools.product(BLOCK_QS, BLOCK_KS)
          if fits(bq, bk, head_dim, dtype)]
    if not ok or (DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K) in ok:
        return DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K
    return max(ok, key=lambda p: (p[0] * p[1], p[0]))


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


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(ctypes.c_int)
    _build.declare(lib, {
        "flash_attention_launch": (i, (vp, vp, vp, vp, i, i, i, i, i, i, i,
                                       i, i, f, i, vp)),
        "flash_attention_attributes": (i, (i, i, i, i, ip, ip, ip)),
        "flash_attention_smem_bytes": (ctypes.c_longlong, (i, i, i, i)),
        "flash_attention_threads": (i, (i, i, i, i)),
    })
    # every point the tuning space may propose: the C figures equal the
    # Python ones, and the bf16 instances are exactly the fitting points
    for dtype, d, bq, bk in itertools.product(
            (torch.bfloat16, torch.float32), HEAD_DIMS, BLOCK_QS, BLOCK_KS):
        flag = int(dtype == torch.bfloat16)
        c = (lib.flash_attention_smem_bytes(bq, bk, d, flag),
             lib.flash_attention_threads(bq, bk, d, flag))
        if fits(bq, bk, d, dtype):
            agree = c == (smem_bytes(bq, bk, d, dtype), threads(bq, d, dtype))
        else:
            agree = not flag or c == (-1, -1)
        if not agree:
            raise RuntimeError(
                f"csrc/flash_attention.cu and kernels/flash_attention.py "
                f"disagree on the {dtype} block at head_dim {d}, block_q "
                f"{bq}, block_k {bk}: C (smem, threads) {c}")
    return lib


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
            f"{WGMMA_BLOCK_KS}; float32: at most {MAX_THREADS} threads; "
            f"shared memory <= {SMEM_PER_BLOCK} B)")
    if b * hq > 65_535 or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: B * Hq > 65,535 or a pointer not "
                         "16-byte aligned")
    o = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq,
            hkv, s, d, block_q, block_k, int(causal), int(window),
            1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16), stream)
    _build.check(code, lib, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0     # kernel launches since the last reset
