"""Decode attention (one query token against a KV cache, GQA, slot-position
masks) — wrapper of the hand-written CUDA kernel
``csrc/decode_attention.cu``.

:func:`decode_attention` launches the kernel on CUDA tensors and runs
:func:`decode_attention_plain`, the same function in plain PyTorch, on CPU
or meta tensors.  On a CUDA tensor it launches or raises; it never falls
back.  The cache is read in place: no padding copy of its ragged tail.
The kernel splits the cache into :func:`decode_splits` contiguous ranges
(split-K), one block each per (b, kv head); a second kernel combines the
blocks' float32 partials in a scratch tensor allocated here.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import math

import torch

from repro_torch.kernels import SMEM_PER_BLOCK, _build

NEG_INF = -1e30
BLOCK_KS = (64, 128, 256)        # cache slots per shared-memory tile
DEFAULT_BLOCK_K = 64
THREADS = 128                    # threads per block, as in the CUDA source
STAGES = 2                       # tiles in the shared-memory ring
MAX_GROUP = 8                    # query heads per kv head
GROUPS = (1, 2, 4, 8)            # query heads per kv head the source builds
HEAD_DIMS = {torch.bfloat16: (16, 32, 64, 128, 256),   # cache rows of
             torch.float32: (16, 32, 64, 128)}         # 32-512 bytes
TARGET_BLOCKS = 2 * 132          # split-K aims at two blocks per H100 SM
_BARRIERS = 32                   # a k and a v mbarrier per ring stage


def decode_splits(batch_kv: int, s: int, block_k: int) -> tuple[int, int]:
    """(splits, tiles per split) of the cache's S slots for ``batch_kv``
    (b, kv head) pairs: the most tiles per split that still give at least
    TARGET_BLOCKS blocks, one where the cache has fewer tiles.  Split i
    covers slots [i * tiles * block_k, min(S, (i + 1) * tiles * block_k));
    none is empty (an empty split would have no max and make the combine
    NaN).  The CUDA source computes the same (``split_tiles``,
    ``split_count``)."""
    n_tiles = -(-s // block_k)
    per = max(n_tiles // -(-TARGET_BLOCKS // batch_kv), 1)
    return -(-n_tiles // per), per


def smem_bytes(group: int, head_dim: int, block_k: int, dtype) -> int:
    """Dynamic shared memory of one block: the barriers, STAGES k and v
    tiles [block_k, D] in the cache's type, and float32 scores [G,
    block_k], per-warp partial sums [4, G, D] and three per-head scalars."""
    elem = torch.empty((), dtype=dtype).element_size()
    return (_BARRIERS + 2 * STAGES * block_k * head_dim * elem
            + 4 * (group * block_k + THREADS // 32 * group * head_dim
                   + 3 * group))


def fits(group: int, head_dim: int, block_k: int, dtype) -> bool:
    """Whether the source builds the kernel for (type, G, D) — G in
    :data:`GROUPS`, D in :data:`HEAD_DIMS` — and the block fits Hopper's
    shared memory."""
    return (dtype in HEAD_DIMS and group in GROUPS
            and head_dim in HEAD_DIMS[dtype] and block_k in BLOCK_KS
            and smem_bytes(group, head_dim, block_k, dtype) <= SMEM_PER_BLOCK)


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
        "decode_attention_launch": (i, (vp, vp, vp, vp, vp, vp, vp, i, i, i,
                                        i, i, i, i, i, f, i, vp)),
        "decode_attention_attributes": (i, (i, i, i, ip, ip, ip)),
        "decode_attention_smem_bytes": (ctypes.c_longlong, (i, i, i, i)),
        "decode_attention_occupancy": (i, (i, i, i, i)),
        "decode_attention_splits": (i, (i, i, i)),
        "decode_attention_threads": (i, ()),
        "decode_attention_max_group": (i, ()),
        "decode_attention_stages": (i, ()),
    })
    agree = (lib.decode_attention_threads() == THREADS
             and lib.decode_attention_max_group() == MAX_GROUP
             and lib.decode_attention_stages() == STAGES)
    # the instances built are exactly the (type, G, D) fits() admits
    for dtype, g, d, bk in itertools.product(
            HEAD_DIMS, range(1, MAX_GROUP + 1), (8, 16, 32, 64, 128, 256),
            BLOCK_KS):
        c = lib.decode_attention_smem_bytes(g, d, bk, int(dtype == torch.bfloat16))
        built = g in GROUPS and d in HEAD_DIMS[dtype]
        agree &= c == (smem_bytes(g, d, bk, dtype) if built else -1)
    for bkv, s, bk in itertools.product((1, 4, 32, 300), (1, 9, 64, 65, 2080),
                                        BLOCK_KS):
        agree &= lib.decode_attention_splits(bkv, s, bk) == decode_splits(
            bkv, s, bk)[0]
    if not agree:
        raise RuntimeError("csrc/decode_attention.cu and "
                           "kernels/decode_attention.py disagree on the "
                           "launch configuration")
    return lib


def kernel_attributes(group: int, head_dim: int, dtype) -> dict:
    """``cudaFuncGetAttributes`` of the split kernel for (G, D, type) (its
    shared memory is dynamic: see :func:`smem_bytes`)."""
    return _build.func_attributes(_lib(), "decode_attention_attributes",
                                  group, head_dim, int(dtype == torch.bfloat16))


def occupancy(group: int, head_dim: int, block_k: int, dtype) -> int:
    """Split blocks resident on one SM at this point, from the CUDA
    occupancy calculator."""
    return _lib().decode_attention_occupancy(group, head_dim, block_k,
                                             int(dtype == torch.bfloat16))


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
    if (not fits(g, d, block_k, q.dtype) or b * hkv > 65_535
            or any(t.data_ptr() % 16 for t in (q, k_cache, v_cache))):
        raise ValueError(f"decode_attention: G={g}, head_dim={d}, block_k="
                         f"{block_k} in {q.dtype} exceeds the kernel's limits "
                         f"(G in {GROUPS}, head_dim in {HEAD_DIMS[q.dtype]}, "
                         f"shared memory <= {SMEM_PER_BLOCK} B, B * Hkv <= "
                         "65,535, 16-byte aligned pointers)")
    splits, _ = decode_splits(b * hkv, s, block_k)
    o = torch.empty_like(q)
    part = torch.empty(b * hq * splits * (d + 2), dtype=torch.float32,
                       device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            slot_pos.data_ptr(), cur_pos.data_ptr(), o.data_ptr(),
            part.data_ptr(), b, hkv, g, s, d, block_k, splits, int(window),
            1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16), stream)
    _build.check(code, lib, "decode_attention")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0    # wrapper calls that launched the kernels
