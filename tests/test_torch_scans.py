"""The port's scans against the JAX package's, on the same NumPy inputs:
the kernels' plain versions (``ssm_scan_plain``, ``rglru_scan_plain``,
the CPU side of the ``hopper`` variants) against the JAX sequential
oracles, and the port's ``ref`` / ``offload`` / ``seq`` region variants
against their JAX namesakes.

Everything runs in float32, where the two sides differ only in summation
order.  Tolerances are the JAX kernel tests' own (tests/test_kernels.py):
1e-4 for the selective scan, 1e-5 for the RG-LRU recurrence.  The Pallas
kernels themselves cannot run here (their interpret mode fails under this
JAX), so the CUDA kernels are held against the same plain versions on the
card (tests/test_torch_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.models import rglru as JRG
from repro.models import ssm as JSS
from repro_torch.core.regions import Impl, dispatch, tuning_space, variants
from repro_torch.core.resources import precompile
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops  # noqa: F401 (registers hopper)
from repro_torch.kernels import ref as R
from repro_torch.kernels import rglru_scan as RS
from repro_torch.kernels import ssm_scan as SS
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as S

SSM_TOL = 1e-4
RGLRU_TOL = 1e-5


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _ssm_inputs(b, s, d, n, seed=0, h0_zero=False):
    """Decays in (0.5, 1) as the model's exp(dt * A) gives, unit inputs."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (b, s, d, n)).astype(np.float32)
    bx = rng.standard_normal((b, s, d, n)).astype(np.float32)
    c = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = (np.zeros((b, d, n), np.float32) if h0_zero
          else rng.standard_normal((b, d, n)).astype(np.float32))
    return a, bx, c, h0


def _rglru_inputs(b, s, d, seed=0, h0_zero=False):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (b, s, d)).astype(np.float32)
    bb = rng.standard_normal((b, s, d)).astype(np.float32)
    h0 = (np.zeros((b, d), np.float32) if h0_zero
          else rng.standard_normal((b, d)).astype(np.float32))
    return a, bb, h0


# (B, S, D, N): a ragged S (no multiple of any chunk or time_chunk), a D no
# multiple of the default 16-channel block, one step, the serving N
SSM_SHAPES = [(2, 37, 12, 8, False), (1, 64, 16, 16, True),
              (1, 1, 3, 4, False), (3, 300, 20, 16, False)]


@pytest.mark.parametrize("b,s,d,n,zero", SSM_SHAPES)
def test_ssm_scan_plain_matches_jax_seq_oracle(b, s, d, n, zero):
    args = _ssm_inputs(b, s, d, n, seed=s + d, h0_zero=zero)
    want = JR.ssm_scan_seq(*map(jnp.asarray, args))
    got = SS.ssm_scan_plain(*map(_t, args))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.float32
    _close(got[0], want[0], SSM_TOL)
    _close(got[1], want[1], SSM_TOL)
    # the port's own oracle is the same function
    for g, w in zip(R.ssm_scan_seq(*map(_t, args)), want):
        _close(g, w, SSM_TOL)


@pytest.mark.parametrize("variant,jfn", [("ref", JSS.ssm_scan_ref),
                                         ("offload", JSS.ssm_scan_offload),
                                         ("seq", JSS.ssm_scan_seq_chunked)])
@pytest.mark.parametrize("b,s,d,n,zero", SSM_SHAPES[:2] + SSM_SHAPES[3:])
def test_ssm_scan_variants_match_jax(variant, jfn, b, s, d, n, zero):
    args = _ssm_inputs(b, s, d, n, seed=s, h0_zero=zero)
    # chunk 16 < S: several chunks and a padded (ref) or short (seq) last one
    want = jfn(*map(jnp.asarray, args), chunk=16)
    got = variants("ssm_scan")[variant](*map(_t, args), chunk=16)
    _close(got[0], want[0], SSM_TOL)
    _close(got[1], want[1], SSM_TOL)
    # and at the default chunk sizes
    want = jfn(*map(jnp.asarray, args))
    got = dispatch("ssm_scan", Impl({"ssm_scan": variant}), *map(_t, args))
    _close(got[0], want[0], SSM_TOL)


def test_ssm_hopper_variant_runs_the_plain_version_on_the_cpu():
    args = tuple(map(_t, _ssm_inputs(2, 37, 12, 8, seed=1)))
    before = SS.ssm_scan.launches
    got = dispatch("ssm_scan", Impl({"ssm_scan": ("hopper", {"block_c": 4,
                                                             "time_chunk": 32})}),
                   *args)
    want = SS.ssm_scan_plain(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert SS.ssm_scan.launches == before          # no kernel on the CPU


def test_ssm_plain_keeps_the_kernel_types_in_bf16():
    a, bx, c, h0 = map(_t, _ssm_inputs(1, 9, 4, 4, seed=2))
    bf = torch.bfloat16
    y, hf = SS.ssm_scan(a.to(bf), bx.to(bf), c.to(bf), h0)
    assert y.dtype == bf and hf.dtype == torch.float32
    # float32 state and sum over N: only the inputs' and y's rounding differ
    y32, h32 = SS.ssm_scan_plain(a.to(bf).float(), bx.to(bf).float(),
                                 c.to(bf).float(), h0)
    torch.testing.assert_close(hf, h32, rtol=0, atol=0)
    torch.testing.assert_close(y, y32.to(bf), rtol=0, atol=0)


@pytest.mark.parametrize("b,s,d,zero", [(2, 37, 12, False), (1, 600, 20, True),
                                        (1, 1, 3, False), (3, 129, 64, False)])
def test_rglru_scan_plain_matches_jax_seq_oracle(b, s, d, zero):
    args = _rglru_inputs(b, s, d, seed=s + d, h0_zero=zero)
    want = JR.rglru_scan_seq(*map(jnp.asarray, args))
    got = RS.rglru_scan_plain(*map(_t, args))
    _close(got[0], want[0], RGLRU_TOL)
    _close(got[1], want[1], RGLRU_TOL)
    for g, w in zip(R.rglru_scan_seq(*map(_t, args)), want):
        _close(g, w, RGLRU_TOL)


@pytest.mark.parametrize("variant,jfn", [("ref", JRG.rglru_scan_ref),
                                         ("offload", JRG.rglru_scan_offload)])
@pytest.mark.parametrize("b,s,d,chunk", [(2, 37, 12, 16), (1, 600, 20, None),
                                         (3, 129, 64, 32)])
def test_rglru_scan_variants_match_jax(variant, jfn, b, s, d, chunk):
    args = _rglru_inputs(b, s, d, seed=s)
    kw = {} if chunk is None else {"chunk": chunk}
    want = jfn(*map(jnp.asarray, args), **kw)
    got = variants("rglru_scan")[variant](*map(_t, args), **kw)
    assert str(got[0].dtype).removeprefix("torch.") == str(want[0].dtype)
    _close(got[0], want[0], RGLRU_TOL)
    _close(got[1], want[1], RGLRU_TOL)


def _rglru_chunked(a, b, h0, time_chunk):
    """Plain-torch emulation of the arithmetic of csrc/rglru_scan.cu.  Each
    chunk's aggregate (A = prod a, H = the chunk's scan from 0) in float32,
    as an affine map h -> A h + H.  Chunks come in groups of GROUP and runs
    of RUN: the chunk ending a run publishes the run's composite; chunk k's
    carry is the composite of the whole runs after its group's first chunk
    j0, then of the chunks of its own run before it, applied to j0's end
    state (A_j0 * carry_j0 + H_j0).  The chunk is then run again from its
    carry, h_all stored in a's type.  Returns (h_all, h_final, the chunks
    whose end state was read)."""
    group, run = RS.GROUP, RS.RUN
    bsz, s, d = a.shape
    af, bf = a.float(), b.float()
    starts = range(0, s, time_chunk)
    one, zero = torch.ones(bsz, d), torch.zeros(bsz, d)

    def then(f, g):              # f, then g
        return g[0] * f[0], g[0] * f[1] + g[1]

    aggs = []
    for t0 in starts:
        f = (one, zero)
        for t in range(t0, min(s, t0 + time_chunk)):
            f = then(f, (af[:, t], bf[:, t]))
        aggs.append(f)
    h_all = torch.empty_like(a)
    ends, runs, read = {}, {}, set()
    for k, t0 in enumerate(starts):
        if k == 0:
            h = h0.float()
        else:
            j0 = (k - 1) // group * group
            whole = (k - j0 - 1) // run
            first = j0 + run * whole + 1
            part = (one, zero)
            for agg in aggs[first:k]:
                part = then(part, agg)
            if (k - j0) % run == 0 and k - j0 < group:
                runs[k] = then(part, aggs[k])
            whole_runs = (one, zero)
            for r in range(whole):
                whole_runs = then(whole_runs, runs[j0 + run * (r + 1)])
            carry = then(whole_runs, part)
            h = carry[0] * ends[j0] + carry[1]
            read.add(j0)
        if k % group == 0:
            ends[k] = aggs[k][0] * h + aggs[k][1]
        for t in range(t0, min(s, t0 + time_chunk)):
            h = af[:, t] * h + bf[:, t]
            h_all[:, t] = h.to(a.dtype)
    return h_all, h, read


def _with_exact_ends(a):
    """a with exact 0s (the carry is cut) and 1s (the carry passes
    whole)."""
    a = a.copy()
    a[:, ::5] = 0.0
    a[:, 2::7] = 1.0
    return a


@pytest.mark.parametrize("time_chunk", RS.TIME_CHUNKS)
@pytest.mark.parametrize("steps", ["1", "9", "tc-1", "tc", "tc+1", "600",
                                   "groups+1"])
@pytest.mark.parametrize("bsz,dtype", [(1, torch.float32), (3, torch.float32),
                                       (1, torch.bfloat16),
                                       (3, torch.bfloat16)])
def test_rglru_chunked_arithmetic_matches_jax(time_chunk, steps, bsz, dtype):
    """The kernel's chunk arithmetic (aggregates, carry chain, fix-up)
    against the JAX sequential oracle and the JAX ``ref`` variant: float32
    at 1e-5 (the composition reorders float32 rounding only); bf16 inputs
    at 2e-2 (the oracles in float32 on the same bf16 values; h_all is
    rounded to bf16 once).  ``groups+1`` spans more than one group of
    chunks and ends ragged."""
    s = {"tc-1": time_chunk - 1, "tc": time_chunk, "tc+1": time_chunk + 1,
         "groups+1": RS.GROUP * time_chunk + time_chunk + 3}.get(steps)
    s = int(steps) if s is None else s
    a, b, h0 = _rglru_inputs(bsz, s, 24, seed=s + bsz)
    a = _with_exact_ends(a)
    a, b = (_t(x).to(dtype) for x in (a, b))
    got_all, got_final, read = _rglru_chunked(a, b, _t(h0), time_chunk)
    chunks = -(-s // time_chunk)
    assert read == {j for j in range(0, chunks - 1, RS.GROUP)}
    ja, jb = (jnp.asarray(x.float().numpy()) for x in (a, b))
    tol = RGLRU_TOL if dtype == torch.float32 else 2e-2
    for want in (JR.rglru_scan_seq(ja, jb, jnp.asarray(h0)),
                 JRG.rglru_scan_ref(ja, jb, jnp.asarray(h0))):
        _close(got_all.float(), want[0], tol)
        _close(got_final, want[1], RGLRU_TOL)


def test_rglru_variants_keep_the_jax_output_types_in_bf16():
    """ref carries h0's float32 (so h_all is float32), offload casts h_all
    back to a's type, hopper stores a's type: as in the JAX package and the
    TPU kernel."""
    a, b, h0 = map(_t, _rglru_inputs(1, 20, 8, seed=3))
    bf = torch.bfloat16
    ja, jb, jh = (jnp.asarray(np.asarray(t)) for t in (a, b, h0))
    jref = JRG.rglru_scan_ref(ja.astype(jnp.bfloat16), jb.astype(jnp.bfloat16),
                              jh)
    joff = JRG.rglru_scan_offload(ja.astype(jnp.bfloat16),
                                  jb.astype(jnp.bfloat16), jh)
    ref = RG.rglru_scan_ref(a.to(bf), b.to(bf), h0)
    off = RG.rglru_scan_offload(a.to(bf), b.to(bf), h0)
    hop = RS.rglru_scan(a.to(bf), b.to(bf), h0)
    assert (ref[0].dtype, str(jref[0].dtype)) == (torch.float32, "float32")
    assert (off[0].dtype, str(joff[0].dtype)) == (bf, "bfloat16")
    assert hop[0].dtype == bf and hop[1].dtype == torch.float32


@pytest.mark.parametrize("kind", ["ssm", "rglru"])
def test_identity_tail_leaves_the_final_state_of_the_prefix(kind):
    """The bucketed-prefill mask: steps with a = 1 and b = 0 past ``length``
    leave h where the real prefix left it, in every variant."""
    n_real, pad = 11, 5
    if kind == "ssm":
        a, bx, c, h0 = _ssm_inputs(1, n_real + pad, 12, 8, seed=7)
        a[:, n_real:], bx[:, n_real:] = 1.0, 0.0
        want = JR.ssm_scan_seq(*map(jnp.asarray, (a[:, :n_real], bx[:, :n_real],
                                                  c[:, :n_real], h0)))[1]
        names, args = ("ref", "offload", "seq", "hopper"), (a, bx, c, h0)
        region, tol = "ssm_scan", SSM_TOL
    else:
        a, b, h0 = _rglru_inputs(1, n_real + pad, 12, seed=7)
        a[:, n_real:], b[:, n_real:] = 1.0, 0.0
        want = JR.rglru_scan_seq(*map(jnp.asarray, (a[:, :n_real],
                                                    b[:, :n_real], h0)))[1]
        names, args = ("ref", "offload", "hopper"), (a, b, h0)
        region, tol = "rglru_scan", RGLRU_TOL
    for name in names:
        got = dispatch(region, Impl({region: name}), *map(_t, args))[1]
        _close(got, want, tol)


@pytest.mark.parametrize("s", [1, 2, 7, 16, 33])
def test_associative_scan_matches_jax(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 3)).astype(np.float32)
    b = rng.standard_normal((2, s, 3)).astype(np.float32)
    want = jax.lax.associative_scan(JSS._assoc_combine,
                                    (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = S.associative_scan(_t(a), _t(b))
    for g, w in zip(got, want):
        _close(g, w, 1e-6)


@pytest.mark.parametrize("length", [None, 3, 7])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_depthwise_conv_matches_jax(length, with_state):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32) if with_state else None
    jl = None if length is None else jnp.asarray(length, jnp.int32)
    want = JSS.causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w),
                                     None if st is None else jnp.asarray(st),
                                     length=jl)
    got = S.causal_depthwise_conv(_t(x), _t(w), None if st is None else _t(st),
                                  length=length)
    for g, wnt in zip(got, want):
        _close(g, wnt, 1e-6)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    a, bx, c, h0 = map(_t, _ssm_inputs(1, 8, 4, 4))
    with pytest.raises(TypeError):
        SS.ssm_scan(a.double(), bx.double(), c.double(), h0)
    with pytest.raises(ValueError):
        SS.ssm_scan(a, bx, c[:, :4], h0)
    with pytest.raises(ValueError):
        SS.ssm_scan(a.transpose(2, 3), bx.transpose(2, 3), c, h0)
    ra, rb, rh = map(_t, _rglru_inputs(1, 8, 4))
    with pytest.raises(TypeError):
        RS.rglru_scan(ra, rb, rh.to(torch.bfloat16))
    with pytest.raises(ValueError):
        RS.rglru_scan(ra, rb[:, :3], rh)


def test_tuning_spaces_and_step3_estimates():
    """The hopper variants' tile genes: the ssm predicate admits whole-warp
    blocks of at most 256 threads (block_c * N / 2) and keeps its chunks in
    registers (0 bytes of shared memory); every rglru point launches, with
    its chunk of a and b and its ticket's chunk index in shared memory (at
    most 128 KB + 16 bytes, float32 at 256 x 64).  Flash at head_dim 256:
    ``test_flash_tiles_at_head_dim_256``."""
    meta = torch.empty((1, 4096, 8192, 16), dtype=torch.bfloat16,
                       device="meta")
    args = (meta, meta,
            torch.empty((1, 4096, 16), dtype=torch.bfloat16, device="meta"),
            torch.empty((1, 8192, 16), device="meta"))
    space = tuning_space("ssm_scan", "hopper")
    pts = space.points(args)
    assert {(p["block_c"], p["time_chunk"]) for p in pts} == {
        (bc, tc) for bc in (4, 8, 16, 32) for tc in (8, 16, 32)}
    est = precompile("ssm_scan", "hopper", variants("ssm_scan")["hopper"],
                     args)
    assert est.lower_ok and est.resource_bytes == 0
    assert not SS.fits(64, 16, 16) and not SS.fits(4, 16, 8)  # 512 / 16 threads
    a = torch.empty((1, 4096, 2560), dtype=torch.bfloat16, device="meta")
    h = torch.empty((1, 2560), device="meta")
    space = tuning_space("rglru_scan", "hopper")
    assert space.size((a, a, h)) == 9
    for p in space.points((a, a, h)):
        est = precompile("rglru_scan", "hopper",
                         variants("rglru_scan")["hopper"], (a, a, h), p)
        assert est.lower_ok and est.resource_bytes == RS.smem_bytes(
            p["block_c"], p["time_chunk"], 2) <= 64 * 1024 + 16
    bare = precompile("rglru_scan", "hopper",
                      variants("rglru_scan")["hopper"], (a, a, h))
    assert bare.resource_bytes == 2 * 32 * 128 * 2 + 16       # 16 KB + 16 B
    f32 = torch.empty((1, 4096, 2560), device="meta")
    assert space.size((f32, f32, h)) == 9
    assert precompile("rglru_scan", "hopper", variants("rglru_scan")["hopper"],
                      (f32, f32, h), {"block_c": 256, "time_chunk": 64}
                      ).resource_bytes == 128 * 1024 + 16


# recurrentgemma's local attention, head_dim 256.  bf16: the wgmma body at
# block_q 64 or 128 and block_k 64 (Q up to 64 KB and two stages of K and V,
# 128 KB; block_k 128 would need 256 KB).  float32: the scalar body at
# block_q <= 64 (16 threads per row group: 512 threads at 128).
@pytest.mark.parametrize("dtype,points,smem,refused", [
    (torch.bfloat16, {(64, 64), (128, 64)}, {(128, 64): 197_760},
     [(64, 128), (32, 64)]),
    (torch.float32, {(32, 32), (32, 64), (64, 32), (64, 64)},
     {(64, 64): 216_320}, [(128, 32)]),
])
def test_flash_tiles_at_head_dim_256(dtype, points, smem, refused):
    q = torch.empty((1, 10, 4096, 256), dtype=dtype, device="meta")
    kv = torch.empty((1, 1, 4096, 256), dtype=dtype, device="meta")
    fpts = tuning_space("attn_core", "hopper").points((q, kv, kv))
    assert {(p["block_q"], p["block_k"]) for p in fpts} == points
    for (bq, bk), n in smem.items():
        assert FA.smem_bytes(bq, bk, 256, dtype) == n
        assert FA.fits(bq, bk, 256, dtype)
    assert not any(FA.fits(bq, bk, 256, dtype) for bq, bk in refused)
    assert FA.default_tiles(dtype, 256) in points
    est = precompile("attn_core", "hopper", variants("attn_core")["hopper"],
                     (q, kv, kv))
    assert est.lower_ok and est.resource_bytes == FA.smem_bytes(
        *FA.default_tiles(dtype, 256), 256, dtype)
