"""Decode attention (one query token against a KV cache, GQA, slot-position
masks) — wrapper of the hand-written CUDA kernel
``csrc/decode_attention.cu``.

:func:`decode_attention` launches the kernel on CUDA tensors and runs
:func:`decode_attention_plain`, the same function in plain PyTorch, on CPU
or meta tensors.  On a CUDA tensor it launches or raises; it never falls
back.  The cache is read in place: no padding copy of its ragged tail.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import SMEM_PER_BLOCK, _build

NEG_INF = -1e30
BLOCK_KS = (64, 128, 256)        # cache slots per shared-memory tile
DEFAULT_BLOCK_K = 128
THREADS = 128                    # threads per block, as in the CUDA source
MAX_OUT = 8                      # (head, column) outputs per thread
_PAD = 4                         # floats of padding per shared-memory row


def smem_bytes(group: int, head_dim: int, block_k: int) -> int:
    """Dynamic shared memory of one block: float32 k and v tiles
    [block_k, D + 4], the G scaled query rows, the [G, block_k] scores,
    three per-head scalars and the tile's slot positions."""
    return (4 * (2 * block_k * (head_dim + _PAD) + group * head_dim
                 + group * block_k + 3 * group) + 4 * block_k)


def _valid(slot_pos, cur_pos, window: int) -> torch.Tensor:
    valid = (slot_pos >= 0) & (slot_pos <= cur_pos[:, None])
    if window:
        valid = valid & (slot_pos > cur_pos[:, None] - window)
    return valid


def decode_attention_plain(q, k_cache, v_cache, slot_pos, cur_pos, *,
                           window: int = 0) -> torch.Tensor:
    """Plain PyTorch version with the kernel's precision: float32
    throughout (q scaled first), o in q's type."""
    b, hq, _, d = q.shape
    _, hkv, s, _ = k_cache.shape
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).float() * (1.0 / math.sqrt(d))
    sc = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float())
    sc = torch.where(_valid(slot_pos, cur_pos, window)[:, None, None, :], sc,
                     NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.float())
    return out.reshape(b, hq, 1, d).to(q.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(ctypes.c_int)
    _build.declare(lib, {
        "decode_attention_launch": (i, (vp, vp, vp, vp, vp, vp, i, i, i, i,
                                        i, i, i, f, i, vp)),
        "decode_attention_attributes": (i, (ip, ip, ip)),
        "decode_attention_smem_bytes": (ctypes.c_longlong, (i, i, i)),
        "decode_attention_threads": (i, ()),
        "decode_attention_max_out": (i, ()),
    })
    if (lib.decode_attention_threads() != THREADS
            or lib.decode_attention_max_out() != MAX_OUT
            or lib.decode_attention_smem_bytes(4, 128, 128)
            != smem_bytes(4, 128, 128)):
        raise RuntimeError("csrc/decode_attention.cu and "
                           "kernels/decode_attention.py disagree on the "
                           "launch configuration")
    return lib


def kernel_attributes() -> dict:
    """``cudaFuncGetAttributes`` of the kernel (its shared memory is
    dynamic: see :func:`smem_bytes`)."""
    return _build.func_attributes(_lib(), "decode_attention_attributes")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, slot_pos: torch.Tensor,
                     cur_pos: torch.Tensor, *, window: int = 0,
                     block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """q: [B, Hq, 1, D]; k/v_cache: [B, Hkv, S, D] (q, k, v all bf16 or all
    float32, contiguous); slot_pos: int32 [B, S] (-1 = empty); cur_pos:
    int32 [B].  Returns [B, Hq, 1, D] in q's type."""
    if (q.dim() != 4 or q.shape[2] != 1 or k_cache.dim() != 4
            or k_cache.shape != v_cache.shape):
        raise ValueError(f"decode_attention: want q [B, Hq, 1, D] and k/v "
                         f"[B, Hkv, S, D], got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, hq, _, d = q.shape
    _, hkv, s, _ = k_cache.shape
    if (k_cache.shape[0] != b or k_cache.shape[3] != d or hq % hkv
            or tuple(slot_pos.shape) != (b, s)
            or tuple(cur_pos.shape) != (b,)):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}, slot_pos "
                         f"{tuple(slot_pos.shape)} and cur_pos "
                         f"{tuple(cur_pos.shape)} do not fit together")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError(f"decode_attention: want q, k, v all bfloat16 or all "
                        f"float32, got {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    if slot_pos.dtype != torch.int32 or cur_pos.dtype != torch.int32:
        raise TypeError(f"decode_attention: want int32 slot_pos and cur_pos, "
                        f"got {slot_pos.dtype} and {cur_pos.dtype}")
    tensors = (q, k_cache, v_cache, slot_pos, cur_pos)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention: every input must be contiguous")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"decode_attention: inputs on "
                         f"{[str(t.device) for t in tensors]}")
    if block_k not in BLOCK_KS:
        raise ValueError(f"decode_attention: block_k={block_k} not in "
                         f"{BLOCK_KS}")
    if q.numel() == 0 or s == 0:
        raise ValueError("decode_attention: empty input")
    if q.device.type in ("cpu", "meta"):
        return decode_attention_plain(q, k_cache, v_cache, slot_pos, cur_pos,
                                      window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    g = hq // hkv
    step = 8 if q.dtype == torch.bfloat16 else 4
    if (g * d > THREADS * MAX_OUT or d % step
            or smem_bytes(g, d, block_k) > SMEM_PER_BLOCK
            or any(t.data_ptr() % 16 for t in (q, k_cache, v_cache))):
        raise ValueError(f"decode_attention: G={g}, head_dim={d}, block_k="
                         f"{block_k} exceeds the kernel's limits (G * D <= "
                         f"{THREADS * MAX_OUT}, D a multiple of {step}, "
                         f"shared memory <= {SMEM_PER_BLOCK} B, 16-byte "
                         "aligned pointers)")
    o = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            slot_pos.data_ptr(), cur_pos.data_ptr(), o.data_ptr(), b, hkv, g,
            s, d, block_k, int(window), 1.0 / math.sqrt(d),
            int(q.dtype == torch.bfloat16), stream)
    _build.check(code, lib, "decode_attention")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0    # kernel launches since the last reset
