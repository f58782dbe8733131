"""Flash attention (causal / sliding-window prefill, GQA) — wrapper of the
hand-written CUDA kernel ``csrc/flash_attention.cu``.

:func:`flash_attention` launches the kernel on CUDA tensors and runs
:func:`flash_attention_plain`, the same function in plain PyTorch, on CPU
or meta tensors.  On a CUDA tensor it launches or raises; it never falls
back.  ``block_q`` / ``block_k`` are the kernel's tile sizes, instantiated
for the values in :data:`BLOCK_QS` / :data:`BLOCK_KS`; S need not be a
multiple of either (the kernel masks its ragged last tiles).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import SMEM_PER_BLOCK, _build

NEG_INF = -1e30
BLOCK_QS = (32, 64, 128)         # query rows per block (see threads())
BLOCK_KS = (32, 64, 128)         # keys per shared-memory tile
HEAD_DIMS = (16, 32, 64, 128, 256)   # head widths the source instantiates
MAX_THREADS = 256
DEFAULT_BLOCK_Q = 64
DEFAULT_BLOCK_K = 64
_PAD = 4                         # floats of padding per shared-memory row


def smem_bytes(block_q: int, block_k: int, head_dim: int) -> int:
    """Dynamic shared memory of one block: float32 q tile [block_q, D + 4],
    k and v tiles [block_k, D + 4], probabilities [block_q, block_k + 1]."""
    ld = head_dim + _PAD
    return 4 * (block_q * ld + 2 * block_k * ld + block_q * (block_k + 1))


def threads(block_q: int, head_dim: int) -> int:
    """Threads of one block: 4 query rows per thread, 8 threads per row
    group (16 at head_dim 256, where 8 would need 128 accumulators each)."""
    return block_q // 4 * (16 if head_dim >= 256 else 8)


def fits(block_q: int, block_k: int, head_dim: int) -> bool:
    """Whether the source instantiates head_dim and the block fits Hopper's
    shared memory and the kernel's thread limit."""
    return (head_dim in HEAD_DIMS
            and threads(block_q, head_dim) <= MAX_THREADS
            and smem_bytes(block_q, block_k, head_dim) <= SMEM_PER_BLOCK)


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
        "flash_attention_attributes": (i, (i, i, ip, ip, ip)),
        "flash_attention_smem_bytes": (ctypes.c_longlong, (i, i, i)),
    })
    for bq in BLOCK_QS:
        for bk in BLOCK_KS:
            if lib.flash_attention_smem_bytes(bq, bk, 128) != smem_bytes(bq, bk, 128):
                raise RuntimeError("csrc/flash_attention.cu and "
                                   "kernels/flash_attention.py disagree on "
                                   "the shared-memory layout")
    return lib


def kernel_attributes(block_k: int = DEFAULT_BLOCK_K,
                      head_dim: int = 128) -> dict:
    """``cudaFuncGetAttributes`` of the instance for (block_k, head_dim)
    (its shared memory is dynamic: see :func:`smem_bytes`)."""
    return _build.func_attributes(_lib(), "flash_attention_attributes",
                                  block_k, head_dim)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """q: [B, Hq, S, D]; k/v: [B, Hkv, S, D], Hq a multiple of Hkv; all
    bf16 or all float32, contiguous.  Returns [B, Hq, S, D] in q's type."""
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
    if block_q not in BLOCK_QS or block_k not in BLOCK_KS:
        raise ValueError(f"flash_attention: block_q={block_q} / block_k="
                         f"{block_k} not in {BLOCK_QS} / {BLOCK_KS}")
    if q.numel() == 0:
        raise ValueError("flash_attention: empty input")
    if q.device.type in ("cpu", "meta"):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if not fits(block_q, block_k, d):
        raise ValueError(f"flash_attention: head_dim {d} with block_q="
                         f"{block_q}, block_k={block_k} exceeds the kernel's "
                         f"limits (head_dim in {HEAD_DIMS}, at most "
                         f"{MAX_THREADS} threads, shared memory <= "
                         f"{SMEM_PER_BLOCK} B)")
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
