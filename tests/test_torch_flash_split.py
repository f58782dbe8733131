"""The bf16 flash kernel's work split (split-KV), emulated in plain PyTorch
and held against the JAX package, and its plan.

* The emulation computes what csrc/flash_attention.cu's split schedule
  does: for every unit of a :class:`SplitPlan` (a q tile and a chunk of
  the kv tiles it visits) the online softmax of the bf16 body over the
  chunk's tiles only (exp2, the masks on edge tiles, NEG_INF = -1e30, p
  rounded to v's type for P.V); an unsplit tile's o directly, a split
  tile's chunks as unnormalized float32 partials in the kernel's
  workspace layout, then ``flash_attention_combine_plain``.  It is held
  against JAX ``kernels/ref.py::attention_ref`` at 2e-2 (bf16) and 2e-5
  (float32, the flash tolerances of tests/test_kernels.py).
* ``split_plan``: every visited (head, q tile, kv tile) in exactly one
  chunk, no chunk of a split tile below 2 kv tiles, the rows of PERF.md at
  their plans.

The kernels themselves run only on a card: ``tests/test_torch_cuda.py``
(``-m cuda``) and ``chip_smoke.py`` phase 3."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ref as JREF
from repro_torch.kernels import flash_attention as FA

NEG_INF = -1e30
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


def _qkv(seed, b, hq, hkv, s, d, dtype):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dtype)
        for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))


def _chunk(qf, kf, vf, rows, lo, n, *, s, causal, window, block_k, vtype):
    """One unit's online softmax for a warpgroup's ``rows`` over kv tiles
    [lo, lo + n): the unnormalized accumulator, m (log2 units) and l."""
    b, hq, _, d = qf.shape
    scale = 1.0 / np.sqrt(d) * np.log2(np.e)
    w0 = int(rows[0])
    m = torch.full((b, hq, len(rows)), NEG_INF)
    l = torch.zeros((b, hq, len(rows)))
    acc = torch.zeros((b, hq, len(rows), d))
    for kt in range(lo, lo + n):
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
            "bhqk,bhkd->bhqd", p.to(vtype).float(), vf[:, :, keys])
        m = mn
    return acc, m, l


def _split_schedule(q, k, v, plan: FA.SplitPlan):
    """o as the split kernel and its combine compute it under ``plan``."""
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    qf = q.float()
    bq, n = plan.block_q, plan.partials
    part = torch.full((plan.workspace_floats,), float("nan"))
    acc_ws = part[:b * hq * n * bq * d].view(b * hq, n, bq, d)
    ml_ws = part[b * hq * n * bq * d:].view(b * hq, n, bq, 2)
    out = torch.full((b, hq, s, d), float("nan"))
    p0 = 0
    kw = dict(s=s, causal=plan.causal, window=plan.window,
              block_k=plan.block_k, vtype=v.dtype)
    for qt, chunks in plan.tiles:
        for c, (lo, nt) in enumerate(chunks):
            for w0 in range(qt * bq, min(qt * bq + bq, s), 64):
                rows = torch.arange(w0, min(w0 + 64, s))
                acc, m, l = _chunk(qf, kf, vf, rows, lo, nt, **kw)
                if len(chunks) == 1:
                    out[:, :, rows] = acc / l.clamp_min(1e-30)[..., None]
                    continue
                at = rows - qt * bq
                acc_ws[:, p0 + c, at] = acc.reshape(b * hq, len(rows), d)
                ml_ws[:, p0 + c, at, 0] = m.reshape(b * hq, len(rows))
                ml_ws[:, p0 + c, at, 1] = l.reshape(b * hq, len(rows))
        if len(chunks) > 1:
            p0 += len(chunks)
    o = out.to(q.dtype)
    return FA.flash_attention_combine_plain(part, plan, o)


def _jax_ref(q, k, v, causal, window):
    dt = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32
    j = [jnp.asarray(t.float().numpy()).astype(dt) for t in (q, k, v)]
    return np.asarray(JREF.attention_ref(*j, causal=causal, window=window),
                      np.float32)


# b, hq, hkv, s, d, causal, window, block_q, block_k, chunk_tiles
SPLIT_CASES = [
    (1, 8, 1, 200, 256, True, 0, 128, 64, 2),      # row 3p at a small S
    (1, 8, 1, 330, 256, True, 0, 128, 64, 3),      # 3p, three chunks
    (1, 4, 4, 300, 64, False, 0, 64, 64, 2),       # bidirectional, ragged
    (1, 4, 4, 520, 64, False, 0, 128, 128, 2),     # 3w's tiles, ragged
    (1, 4, 2, 400, 32, True, 70, 128, 64, 2),      # window empties chunks
    (2, 4, 2, 360, 16, True, 200, 64, 64, 2),      # window, B > 1
    (1, 4, 1, 100, 64, True, 0, 128, 32, 2),       # S < block_q
    (1, 8, 2, 300, 32, True, 0, 128, 64, 2),       # GQA 4:1
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window,bq,bk,t", SPLIT_CASES)
def test_split_schedule_matches_jax_attention_ref(dtype, b, hq, hkv, s, d,
                                                  causal, window, bq, bk, t):
    q, k, v = _qkv(s + d + t, b, hq, hkv, s, d, dtype)
    plan = FA.SplitPlan(b, hq, s, d, bq, bk, causal, window, t)
    assert plan.partials > 0                   # the case splits something
    got = _split_schedule(q, k, v, plan)
    assert not torch.isnan(got.float()).any()
    want = _jax_ref(q, k, v, causal, window)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_a_chunk_the_window_empties_has_weight_zero():
    """Rows 325-383 of q tile 2 at window 70 see none of its first chunk's
    keys (tiles 2-3, keys 128-255): their (m, l) stay (NEG_INF, keys) and
    the combine weighs them 0, not NaN."""
    b, hq, s, d = 1, 2, 400, 32
    q, k, v = _qkv(3, b, hq, hq, s, d, torch.float32)
    plan = FA.SplitPlan(b, hq, s, d, 128, 64, True, 70, 2)
    qt, chunks = next((qt, c) for qt, c in plan.tiles if qt == 2)
    assert chunks == ((2, 2), (4, 2))
    rows = torch.arange(320, 384)              # warpgroup 1's rows
    acc, m, l = _chunk(q.float(), k.float(), v.float(), rows, 2, 2, s=s,
                       causal=True, window=70, block_k=64, vtype=v.dtype)
    assert (m[..., 5:] == NEG_INF).all() and (l[..., 5:] == 128).all()
    assert (m[..., :5] > NEG_INF).all()       # rows 320-324 see key 255
    got = _split_schedule(q, k, v, plan)
    np.testing.assert_allclose(got.numpy(), _jax_ref(q, k, v, True, 70),
                               rtol=2e-5, atol=2e-5)


def test_the_combine_wrapper_is_the_plain_version_on_the_cpu():
    b, hq, s, d = 1, 4, 300, 64
    q, k, v = _qkv(7, b, hq, hq, s, d, torch.bfloat16)
    plan = FA.SplitPlan(b, hq, s, d, 128, 64, True, 0, 2)
    rng = np.random.default_rng(8)
    part = torch.from_numpy(rng.standard_normal(
        plan.workspace_floats).astype(np.float32))
    o = FA.flash_attention_plain(q, k, v)
    want = FA.flash_attention_combine_plain(part, plan, o)
    before = FA.flash_attention_combine.launches
    got = FA.flash_attention_combine(part, plan, o.clone())
    assert FA.flash_attention_combine.launches == before   # CPU: no kernel
    assert torch.equal(got, want)
    # the unsplit q tile (the first) keeps o's rows
    assert torch.equal(got[:, :, :128], o[:, :, :128])
    with pytest.raises(ValueError):
        FA.flash_attention_combine(part[:-1], plan, o.clone())


def _visited(b, hq, s, bq, bk, causal, window):
    out = set()
    for h in range(b * hq):
        for qt in range(-(-s // bq)):
            lo, hi = FA.visit_range(qt, s, bq, bk, causal, window)
            out |= {(h, qt, kt) for kt in range(lo, hi)}
    return out


@settings(max_examples=60, deadline=None)
@given(b=st.integers(1, 3), hq=st.integers(1, 16), s=st.integers(1, 3000),
       d=st.sampled_from(FA.HEAD_DIMS),
       tiles=st.sampled_from([(64, 64), (64, 128), (128, 64), (128, 128)]),
       causal=st.booleans(), window=st.sampled_from([0, 0, 48, 300, 1024]),
       n_sm=st.sampled_from([4, 16, 132]), ctas=st.sampled_from([1, 2]))
def test_split_plan_covers_every_visited_tile_once(b, hq, s, d, tiles, causal,
                                                   window, n_sm, ctas):
    bq, bk = tiles
    plan = FA.split_plan(b, hq, s, d, bq, bk, causal, window, n_sm, ctas)
    seen = []
    for h in range(b * hq):
        for qt, chunks in plan.tiles:
            for lo, n in chunks:
                assert n >= 1
                if len(chunks) > 1:
                    assert n >= FA.SPLIT_MIN_TILES
                seen += [(h, qt, kt) for kt in range(lo, lo + n)]
    assert len(seen) == len(set(seen))
    assert set(seen) == _visited(b, hq, s, bq, bk, causal, window)
    assert plan.units == sum(len(c) for _, c in plan.tiles)
    # a chunk is at most chunk_tiles long, or no longer than the others
    for _, chunks in plan.tiles:
        sizes = [n for _, n in chunks]
        assert max(sizes) - min(sizes) <= 1
        if len(chunks) > 1:
            assert min(sizes) <= plan.chunk_tiles


def test_split_plan_at_the_rows_of_the_kernel_table():
    """On 132 SMs of one block, the plans PERF.md's rows run: row 3 (512
    blocks, ranges of 1-16 tiles, its fastest cut on the card unsplit)
    keeps one unit a q tile; row 3w (144 equal blocks, two waves) cuts
    every q tile in two; rows 3b and 3p cut their longest q tiles."""
    def plan(b, hq, s, d, bq, bk, causal, window):
        return FA.split_plan(b, hq, s, d, bq, bk, causal, window, 132, 1)

    assert plan(1, 32, 2048, 128, 128, 128, True, 0).chunk_tiles == 0
    w = plan(1, 12, 1500, 64, 128, 128, False, 0)
    assert [len(c) for _, c in w.tiles] == [2] * 12
    p768 = plan(1, 8, 768, 256, 128, 64, True, 0)
    assert [len(c) for _, c in p768.tiles] == [3, 3, 2, 2, 1, 1]
    for s in (272, 2080):
        assert plan(1, 8, s, 256, 128, 64, True, 0).partials > 0
    assert plan(1, 10, 2048, 256, 128, 64, True, 2048).partials > 0
    # a grid of 4 waves or more is never cut, whatever the ranges
    big = plan(4, 32, 2048, 128, 128, 128, True, 0)
    assert big.chunk_tiles == 0 and big.units == 16
