"""Registration of the model regions' ``hopper`` variants (the hand-written
CUDA kernels) and of the ``decode_attn`` and ``rmsnorm`` regions — the port
of the JAX package's ``kernels/ops.py`` for the attention, scan and norm
kernels.

Each ``hopper`` variant declares a Step-3 shared-memory estimator, and each
but ``rmsnorm``'s a :class:`TuningSpace` (the JAX package declares none for
``rmsnorm``, whose only variant there is ``pallas``).  The tile genes
differ from the JAX package's: its axes (``block_q`` up to 512, ``block_k`` up to 1024, ``0`` = auto)
were sized for 16 MiB of TPU VMEM, where a 1024 x 128 bf16 K-plus-V tile
(512 KB) fits; no Hopper block can hold that.  Here the axes are the tile
sizes the CUDA sources instantiate, and the validity predicate admits a
point only when its block fits the 232,448 bytes of shared memory a
Hopper block may use.  The scans' axes are likewise the CUDA sources'
instances (the JAX ``block_c`` / ``time_chunk`` genes had to divide D and
S; the Hopper kernels mask their ragged edges, so no divisibility rule is
needed).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.regions import TuningSpace, register_variant
from repro_torch.core.resources import register_smem_estimator
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rglru_scan as RS
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ssm_scan as SS


def _dim(args, idx: int, axis: int):
    """Shape dimension of an abstract region arg, or None when the
    validity query is unbound (args absent or shaped differently)."""
    try:
        return args[idx].shape[axis]
    except (TypeError, IndexError, AttributeError):
        return None


# ---------------------------------------------------------------------------
# attn_core: flash attention
# ---------------------------------------------------------------------------
def _attn_tile_ok(p, args) -> bool:
    # bf16 admits the points its wgmma body is built for (block_q and
    # block_k in {64, 128}), float32 the scalar body's; both within shared
    # memory
    d = _dim(args, 0, 3)
    if d is None:
        return True
    return FA.fits(p["block_q"], p["block_k"], d, args[0].dtype)


# The bare gene runs the kernel's default tiles for the type and head width
# (FA.default_tiles): the declared defaults wherever they fit, so a gene
# equal to them and the bare gene run the same point.
@register_variant("attn_core", "hopper", tuning=TuningSpace(
    axes={"block_q": FA.BLOCK_QS, "block_k": FA.BLOCK_KS},
    defaults={"block_q": FA.DEFAULT_BLOCK_Q, "block_k": FA.DEFAULT_BLOCK_K},
    validity=_attn_tile_ok))
def attn_core_hopper(q, k, v, *, causal=True, window=0, block_q=None,
                     block_k=None):
    return FA.flash_attention(q, k, v, causal=causal, window=window,
                              block_q=block_q, block_k=block_k)


@register_smem_estimator("attn_core", "hopper")
def _attn_hopper_smem(q, k, v, *, block_q=None, block_k=None, **_):
    d = q.shape[-1]
    if block_q is None or block_k is None:
        dq, dk = FA.default_tiles(q.dtype, d)
        block_q = dq if block_q is None else block_q
        block_k = dk if block_k is None else block_k
    return FA.smem_bytes(block_q, block_k, d, q.dtype)


# ---------------------------------------------------------------------------
# decode_attn: one token against the KV cache
# ---------------------------------------------------------------------------
@register_variant("decode_attn", "ref")
def decode_attn_ref(q, k_cache, v_cache, slot_pos, cur_pos, *, window=0):
    """Loop-faithful decode-attention oracle: dense masked softmax over the
    whole KV cache, in float32.  The planner's host-side baseline for the
    region (the hopper kernel computes this, streamed in tiles)."""
    b, hq, _, d = q.shape
    _, hkv, s, _ = k_cache.shape
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).float()
    scores = torch.einsum("bhgd,bhsd->bhgs", qg,
                          k_cache.float()) / math.sqrt(d)
    valid = (slot_pos >= 0) & (slot_pos <= cur_pos[:, None])
    if window:
        valid = valid & (slot_pos > cur_pos[:, None] - window)
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", probs, v_cache.float())
    return out.reshape(b, hq, 1, d).to(q.dtype)


def _decode_tile_ok(p, args) -> bool:
    # the ring of STAGES k and v tiles in the cache's type within shared
    # memory, and a group and row width the kernel takes
    d, hq, hkv = _dim(args, 0, 3), _dim(args, 0, 1), _dim(args, 1, 1)
    if None in (d, hq, hkv):
        return True
    return DA.fits(hq // hkv, d, p["block_k"], args[1].dtype)


@register_variant("decode_attn", "hopper", tuning=TuningSpace(
    axes={"block_k": DA.BLOCK_KS},
    defaults={"block_k": DA.DEFAULT_BLOCK_K},
    validity=_decode_tile_ok))
def decode_attn_hopper(q, k_cache, v_cache, slot_pos, cur_pos, *, window=0,
                       block_k=DA.DEFAULT_BLOCK_K):
    return DA.decode_attention(q, k_cache, v_cache, slot_pos, cur_pos,
                               window=window, block_k=block_k)


@register_smem_estimator("decode_attn", "hopper")
def _decode_hopper_smem(q, k_cache, *_, block_k=DA.DEFAULT_BLOCK_K, **__):
    return DA.smem_bytes(q.shape[1] // k_cache.shape[1], q.shape[-1], block_k,
                         k_cache.dtype)


# ---------------------------------------------------------------------------
# ssm_scan: Mamba-1 selective scan
# ---------------------------------------------------------------------------
def _ssm_tile_ok(p, args) -> bool:
    # whole warps of at most 256 threads (block_c * N); no shared memory
    n = _dim(args, 0, 3)
    return n is None or SS.fits(p["block_c"], p["time_chunk"], n)


@register_variant("ssm_scan", "hopper", tuning=TuningSpace(
    axes={"block_c": SS.BLOCK_CS, "time_chunk": SS.TIME_CHUNKS},
    defaults={"block_c": SS.DEFAULT_BLOCK_C,
              "time_chunk": SS.DEFAULT_TIME_CHUNK},
    validity=_ssm_tile_ok))
def ssm_scan_hopper(a, bx, c, h0, *, block_c=SS.DEFAULT_BLOCK_C,
                    time_chunk=SS.DEFAULT_TIME_CHUNK):
    # the kernel carries a float32 state; a region found by static
    # extraction binds the ref's h0 after its cast to a's type (exact here)
    return SS.ssm_scan(a, bx, c, h0.float(), block_c=block_c,
                       time_chunk=time_chunk)


@register_smem_estimator("ssm_scan", "hopper")
def _ssm_hopper_smem(*_, **__):
    return 0        # the kernel keeps its chunks in registers


# ---------------------------------------------------------------------------
# rglru_scan: RG-LRU linear recurrence
# ---------------------------------------------------------------------------
@register_variant("rglru_scan", "hopper", tuning=TuningSpace(
    axes={"block_c": RS.BLOCK_CS, "time_chunk": RS.TIME_CHUNKS},
    defaults={"block_c": RS.DEFAULT_BLOCK_C,
              "time_chunk": RS.DEFAULT_TIME_CHUNK}))
def rglru_scan_hopper(a, b, h0, *, block_c=RS.DEFAULT_BLOCK_C,
                      time_chunk=RS.DEFAULT_TIME_CHUNK):
    # every point launches (at most 256 threads and 128 KB of shared
    # memory, any S and D), so the space needs no validity predicate
    return RS.rglru_scan(a, b, h0, block_c=block_c, time_chunk=time_chunk)


@register_smem_estimator("rglru_scan", "hopper")
def _rglru_hopper_smem(a, *_, block_c=RS.DEFAULT_BLOCK_C,
                       time_chunk=RS.DEFAULT_TIME_CHUNK, **__):
    return RS.smem_bytes(block_c, time_chunk, a.element_size())


# ---------------------------------------------------------------------------
# rmsnorm: reached only through static extraction (core/extract.py), as in
# the JAX package, where the models call the plain layers.rms_norm
# ---------------------------------------------------------------------------
@register_variant("rmsnorm", "hopper")
def rmsnorm_hopper(x, w, eps=1e-6):
    return RN.rmsnorm(x, w, eps=eps)


@register_smem_estimator("rmsnorm", "hopper")
def _rmsnorm_hopper_smem(*_, **__):
    return RN.smem_bytes()
