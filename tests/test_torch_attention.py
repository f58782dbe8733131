"""The attention kernels' plain versions (what the ``hopper`` wrappers run on
the CPU) against the JAX package, on the same NumPy inputs, and the
wrappers' checks, tuning spaces and Step-3 estimates.

* Flash: against JAX ``kernels/ref.py::attention_ref`` and
  ``models/layers.py::chunked_attention`` (the JAX Pallas flash kernel
  raises ``AttributeError`` on ``pl.load`` under this jax version), in
  float32 with the flash tolerance of tests/test_kernels.py, 2e-5.
* Decode: against the interpret-mode Pallas ``decode_attention`` (which
  runs) and ``kernels/ops.py::decode_attn_ref``, with 5e-6.

The CUDA kernels themselves run only on a card: see
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.models import layers as JL
from repro_torch.core.regions import tuning_space, variants
from repro_torch.core.resources import precompile
from repro_torch.kernels import SMEM_PER_BLOCK, _build
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF

FLASH_TOL = 2e-5
NEG_INF = -1e30
DECODE_TOL = 5e-6


@pytest.fixture
def no_cuda_build(monkeypatch):
    """Any attempt to build or load a CUDA library fails the test."""
    def refuse(name):
        raise AssertionError(f"CUDA library {name!r} loaded on a CPU path")
    monkeypatch.setattr(_build, "load", refuse)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _qkv(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
FLASH_CASES = [
    # b, hq, hkv, s, d, causal, window
    (1, 4, 4, 64, 16, True, 0),        # causal, MHA
    (2, 8, 2, 48, 32, True, 0),        # GQA 4:1
    (1, 4, 2, 37, 16, True, 0),        # ragged S (no tile multiple)
    (1, 4, 1, 100, 64, True, 24),      # sliding window
    (2, 4, 2, 33, 16, False, 0),       # bidirectional, ragged
]


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", FLASH_CASES)
def test_flash_plain_matches_jax_attention_ref(no_cuda_build, b, hq, hkv, s,
                                               d, causal, window):
    q, k, v = _qkv(s + d, b, hq, hkv, s, d)
    want = JREF.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window)
    before = FA.flash_attention.launches
    got = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             window=window)
    assert FA.flash_attention.launches == before      # CPU: no kernel
    _close(got, want, FLASH_TOL)
    _close(TREF.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window), want, FLASH_TOL)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window",
                         [c for c in FLASH_CASES if c[5]])
def test_flash_plain_matches_jax_chunked_attention(b, hq, hkv, s, d, causal,
                                                   window):
    q, k, v = _qkv(2 * s, b, hq, hkv, s, d)
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                q_chunk=16, k_chunk=32)
    got = FA.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal,
                                   window=window)
    _close(got, want, FLASH_TOL)


def test_flash_plain_rounds_p_to_bf16_like_the_kernel():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(5, 1, 4, 2, 40, 16))
    got = FA.flash_attention_plain(q, k, v)
    assert got.dtype == torch.bfloat16
    _close(got.float(), TREF.attention_ref(q, k, v).float(), 2e-2)


@pytest.mark.parametrize("bad", ["dtype", "mixed", "noncontig", "shape",
                                 "group", "block"])
def test_flash_wrapper_raises_on_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, 1, 4, 2, 16, 16))
    kw = {}
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed":
        q = q.to(torch.bfloat16)
    elif bad == "noncontig":
        q = q.transpose(2, 3)
    elif bad == "shape":
        k = k[:, :, :8]
        v = v[:, :, :8]
    elif bad == "group":
        q = q[:, :3].contiguous()
    else:
        kw = {"block_q": 48}
    with pytest.raises((TypeError, ValueError)):
        FA.flash_attention(q, k, v, **kw)


# bf16: the wgmma body's points (block_q and block_k in {64, 128}), all
# within shared memory at head_dim 128 (the largest, 128 x 128, is 164,992
# B: Q 32 KB and two stages of K and V, 128 KB, in bf16); float32: the
# split-TF32 wgmma body's 64 x 32, 64 x 64 and 128 x 32 (block_k 128 would
# need 256 KB a stage; 128 x 64 more registers than a consumer has)
@pytest.mark.parametrize("dtype,n_points,missing", [
    (torch.bfloat16, 4, [{"block_q": 32, "block_k": 64},
                         {"block_q": 64, "block_k": 32}]),
    (torch.float32, 3, [{"block_q": 128, "block_k": 128},
                        {"block_q": 128, "block_k": 64},
                        {"block_q": 32, "block_k": 32}]),
])
def test_flash_tuning_space_fits_hopper_shared_memory(dtype, n_points,
                                                      missing):
    space = tuning_space("attn_core", "hopper")
    q = torch.empty((1, 32, 4096, 128), dtype=dtype, device="meta")
    kv = torch.empty((1, 8, 4096, 128), dtype=dtype, device="meta")
    points = space.points((q, kv, kv))
    assert len(points) == n_points
    assert all(p not in points for p in missing)
    assert all(FA.smem_bytes(p["block_q"], p["block_k"], 128, dtype)
               <= SMEM_PER_BLOCK for p in points)
    assert FA.smem_bytes(128, 128, 128, torch.bfloat16) == 164_992
    # the JAX genes were sized for VMEM: its largest tile would not fit
    assert FA.smem_bytes(512, 1024, 128, dtype) > SMEM_PER_BLOCK
    est = precompile("attn_core", "hopper", variants("attn_core")["hopper"],
                     (q, kv, kv), params={"block_q": 128, "block_k": 64})
    assert est.lower_ok and est.resource_bytes == FA.smem_bytes(
        128, 64, 128, dtype)
    # the bare gene runs (and is estimated at) the default tiles that fit
    bare = precompile("attn_core", "hopper", variants("attn_core")["hopper"],
                      (q, kv, kv))
    bq, bk = FA.default_tiles(dtype, 128)
    assert {"block_q": bq, "block_k": bk} in points
    assert bare.lower_ok and bare.resource_bytes == FA.smem_bytes(
        bq, bk, 128, dtype)


# ---------------------------------------------------------------------------
# the bf16 kernel's tile schedule, emulated in plain PyTorch
# ---------------------------------------------------------------------------
def _flash_schedule(q, k, v, *, causal, window, block_q, block_k):
    """What csrc/flash_attention.cu's bf16 body computes, tile by tile: per
    q tile only the kv tiles its skip rule admits (below the causal
    diagonal, not wholly below the window), S = Q K^T in float32 scaled
    after the product (times log2 e, for exp2), the mask applied only on
    tiles at an edge of a 64-row warpgroup's rows, an online softmax with
    NEG_INF = -1e30, p rounded to v's type for P.V and the row sum over the
    unrounded p, o = acc / max(l, 1e-30) in q's type."""
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    qf = q.float()
    scale = 1.0 / np.sqrt(d) * np.log2(np.e)
    n_tiles = -(-s // block_k)
    out = torch.zeros((b, hq, s, d))
    for q0 in range(0, s, block_q):
        kt_end = min(n_tiles, -(-(q0 + block_q) // block_k)) if causal \
            else n_tiles
        kt_begin = (q0 - window + 1) // block_k \
            if window and q0 - window + 1 > 0 else 0
        for w0 in range(q0, min(q0 + block_q, s), 64):   # a warpgroup's rows
            rows = torch.arange(w0, min(w0 + 64, s))
            m = torch.full((b, hq, len(rows)), NEG_INF)
            l = torch.zeros((b, hq, len(rows)))
            acc = torch.zeros((b, hq, len(rows), d))
            for kt in range(kt_begin, kt_end):
                k0 = kt * block_k
                keys = torch.arange(k0, min(k0 + block_k, s))
                sc = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, rows],
                                  kf[:, :, keys]) * scale
                if (k0 + block_k > s or (causal and k0 + block_k - 1 > w0)
                        or (window and k0 <= w0 + 63 - window)):
                    ok = torch.ones((len(rows), len(keys)), dtype=torch.bool)
                    if causal:
                        ok &= keys[None, :] <= rows[:, None]
                    if window:
                        ok &= keys[None, :] > rows[:, None] - window
                    sc = torch.where(ok, sc, NEG_INF)
                mn = torch.maximum(m, sc.amax(-1))
                p = torch.exp2(sc - mn[..., None])
                alpha = torch.exp2(m - mn)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "bhqk,bhkd->bhqd", p.to(v.dtype).float(), vf[:, :, keys])
                m = mn
            out[:, :, rows] = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window,bq,bk", [
    (1, 4, 1, 200, 16, True, 0, 128, 64),      # ragged S, GQA 4:1
    (1, 2, 2, 150, 16, True, 0, 64, 128),      # ragged S, MHA
    (2, 4, 2, 300, 64, True, 70, 128, 128),    # window inside a tile
    (1, 2, 1, 260, 64, True, 100, 64, 64),     # window: tiles skipped
    (1, 2, 1, 140, 256, True, 0, 128, 64),     # head_dim 256
    (1, 4, 2, 100, 64, False, 0, 64, 64),      # bidirectional
])
def test_flash_tile_schedule_matches_jax_attention_ref(dtype, b, hq, hkv, s,
                                                       d, causal, window, bq,
                                                       bk):
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _qkv(s + d + bq, b, hq, hkv, s, d))
    got = _flash_schedule(q, k, v, causal=causal, window=window, block_q=bq,
                          block_k=bk)
    j = [jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
        for t in (q, k, v)]
    want = JREF.attention_ref(*j, causal=causal, window=window)
    _close(got.float(), np.asarray(want, np.float32),
           2e-2 if dtype == torch.bfloat16 else FLASH_TOL)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------
def _decode_inputs(seed, b, hq, hkv, s, d, empties):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    sp = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    cur = np.full((b,), s - 1, np.int32)
    if empties:
        sp[0, s // 2:] = -1
        cur[0] = s // 2 - 1
    return q, k, v, sp, cur


DECODE_CASES = [
    # b, hq, hkv, s, d, window, empties
    (2, 8, 2, 512, 64, 0, False),      # the decode_attn program's shape
    (2, 4, 2, 100, 16, 0, True),       # ragged S, empty slots
    (3, 8, 2, 130, 32, 40, True),      # sliding window
    (1, 4, 4, 64, 16, 0, False),
]


@pytest.mark.parametrize("b,hq,hkv,s,d,window,empties", DECODE_CASES)
def test_decode_plain_matches_jax_pallas_and_ref(no_cuda_build, b, hq, hkv, s,
                                                 d, window, empties):
    args = _decode_inputs(s + d, b, hq, hkv, s, d, empties)
    jargs = tuple(map(jnp.asarray, args))
    pallas = jax_decode(*jargs, window=window, block_k=64, interpret=True)
    ref = JOPS.decode_attn_ref(*jargs, window=window)
    targs = tuple(map(torch.from_numpy, args))
    before = DA.decode_attention.launches
    got = DA.decode_attention(*targs, window=window)
    assert DA.decode_attention.launches == before      # CPU: no kernel
    _close(got, pallas, DECODE_TOL)
    _close(got, ref, DECODE_TOL)
    _close(TOPS.decode_attn_ref(*targs, window=window), ref, DECODE_TOL)
    _close(variants("decode_attn")["hopper"](*targs, window=window,
                                             block_k=256), ref, DECODE_TOL)


@pytest.mark.parametrize("bad", ["dtype", "pos_dtype", "noncontig", "shape",
                                 "block"])
def test_decode_wrapper_raises_on_what_the_kernel_does_not_take(bad):
    q, k, v, sp, cur = map(torch.from_numpy,
                           _decode_inputs(7, 2, 4, 2, 32, 16, False))
    kw = {}
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "pos_dtype":
        sp = sp.long()
    elif bad == "noncontig":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "shape":
        sp = sp[:, :16]
    else:
        kw = {"block_k": 96}
    with pytest.raises((TypeError, ValueError)):
        DA.decode_attention(q, k, v, sp, cur, **kw)


def _decode_meta(hq, hkv, s, d, dtype):
    return (torch.empty((2, hq, 1, d), dtype=dtype, device="meta"),
            torch.empty((2, hkv, s, d), dtype=dtype, device="meta"),
            torch.empty((2, hkv, s, d), dtype=dtype, device="meta"),
            torch.empty((2, s), dtype=torch.int32, device="meta"),
            torch.empty((2,), dtype=torch.int32, device="meta"))


# the ring holds two stages of k and v tiles in the cache's type: at the
# decode_attn program's head_dim 64 a float32 256-slot stage is 128 KB, so
# two do not fit; at the serving head_dim 128 a bf16 256-slot ring is 256
# KB and a float32 128-slot one too
@pytest.mark.parametrize("dtype,program_points,serving_points", [
    (torch.bfloat16, [64, 128, 256], [64, 128]),
    (torch.float32, [64, 128], [64]),
])
def test_decode_tuning_space_and_estimate(dtype, program_points,
                                          serving_points):
    space = tuning_space("decode_attn", "hopper")
    assert [p["block_k"] for p in space.points(
        _decode_meta(8, 2, 512, 64, dtype))] == program_points
    assert [p["block_k"] for p in space.points(
        _decode_meta(32, 8, 2080, 128, dtype))] == serving_points
    est = precompile("decode_attn", "hopper", variants("decode_attn")["hopper"],
                     _decode_meta(8, 2, 512, 64, dtype))
    elem = 2 if dtype == torch.bfloat16 else 4
    assert est.lower_ok and est.resource_bytes == DA.smem_bytes(
        4, 64, DA.DEFAULT_BLOCK_K, dtype) == (
        32 + 2 * DA.STAGES * DA.DEFAULT_BLOCK_K * 64 * elem
        + 4 * (4 * DA.DEFAULT_BLOCK_K + 4 * 4 * 64 + 3 * 4))
    # more query heads per kv head than the kernel holds in registers
    assert space.points(_decode_meta(18, 2, 512, 64, dtype)) == []


@pytest.mark.parametrize("s", [1, 9, 63, 64, 65, 512, 2080, 4096])
def test_decode_splits_cover_the_cache_with_no_empty_split(s):
    for bkv, block_k in itertools.product((1, 2, 4, 32, 300), DA.BLOCK_KS):
        splits, per = DA.decode_splits(bkv, s, block_k)
        bounds = [(i * per * block_k, min(s, (i + 1) * per * block_k))
                  for i in range(splits)]
        assert bounds[0][0] == 0 and bounds[-1][1] == s
        assert all(lo < hi for lo, hi in bounds)                # none empty
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        n_tiles = -(-s // block_k)
        # enough blocks for the card wherever the cache has the tiles
        assert splits * bkv >= DA.TARGET_BLOCKS or splits == n_tiles
        assert splits <= n_tiles
    # the serving shape: 4 sequences x 8 kv heads over 2,080 slots
    assert DA.decode_splits(32, 2080, 64) == (11, 3)       # 352 blocks
    assert DA.decode_splits(32, 2080, 128) == (17, 1)      # 544 blocks


def _split_k(q, k, v, sp, cur, *, window, block_k):
    """What csrc/decode_attention.cu computes: per split of decode_splits, a
    float32 online softmax over its tiles (NEG_INF on masked slots), the
    partial (m, l, acc); then the combine, o = sum_i acc_i exp(m_i - M) /
    max(sum_i l_i exp(m_i - M), 1e-30)."""
    b, hq, _, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    splits, per = DA.decode_splits(b * hkv, s, block_k)
    qg = q.reshape(b, hkv, g, d).float() * (1.0 / np.sqrt(d))
    valid = (sp >= 0) & (sp <= cur[:, None])
    if window:
        valid &= sp > cur[:, None] - window
    parts = []
    for i in range(splits):
        m = torch.full((b, hkv, g), NEG_INF)
        l = torch.zeros((b, hkv, g))
        acc = torch.zeros((b, hkv, g, d))
        for t0 in range(i * per * block_k, min(s, (i + 1) * per * block_k),
                        block_k):
            t1 = min(s, t0 + block_k, (i + 1) * per * block_k)
            sc = torch.einsum("bhgd,bhsd->bhgs", qg, k[:, :, t0:t1].float())
            sc = torch.where(valid[:, None, None, t0:t1], sc, NEG_INF)
            mn = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - mn[..., None])
            alpha = torch.exp(m - mn)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgs,bhsd->bhgd", p, v[:, :, t0:t1].float())
            m = mn
        parts.append((m, l, acc))
    m = torch.stack([p[0] for p in parts])
    w = torch.exp(m - m.amax(0))
    den = (torch.stack([p[1] for p in parts]) * w).sum(0).clamp_min(1e-30)
    out = (torch.stack([p[2] for p in parts]) * w[..., None]).sum(0)
    return (out / den[..., None]).reshape(b, hq, 1, d).to(q.dtype)


@pytest.mark.parametrize("b,hq,hkv,s,d,window,case", [
    (2, 4, 2, 100, 16, 0, "empties"),          # S no multiple of a split
    (3, 8, 2, 130, 32, 40, "window"),
    (2, 8, 2, 192, 16, 0, "all masked"),       # row 0: every slot empty
    (4, 32, 8, 2080, 16, 0, "serving"),        # 11 splits of 3 tiles
    (4, 32, 8, 2080, 16, 300, "serving window"),
])
def test_decode_split_k_emulation_matches_jax_pallas_and_ref(b, hq, hkv, s, d,
                                                             window, case):
    q, k, v, sp, cur = _decode_inputs(s + d + window, b, hq, hkv, s, d,
                                      case != "serving")
    if case == "all masked":
        sp[0] = -1
    jargs = tuple(map(jnp.asarray, (q, k, v, sp, cur)))
    # the Pallas wrapper pads S to its block with masked slots, which a row
    # with every slot masked would average in: 64 divides each S here but 100
    # and 130, whose rows all have valid slots
    pallas = jax_decode(*jargs, window=window, block_k=64, interpret=True)
    ref = JOPS.decode_attn_ref(*jargs, window=window)
    targs = tuple(map(torch.from_numpy, (q, k, v, sp, cur)))
    for block_k in DA.BLOCK_KS:
        got = _split_k(*targs, window=window, block_k=block_k)
        _close(got, ref, DECODE_TOL)
        _close(got, pallas, DECODE_TOL)
    if case == "all masked":        # a uniform average of v over the cache
        _close(got[0, :, 0], v[0].mean(axis=1).repeat(hq // hkv, axis=0),
               DECODE_TOL)
