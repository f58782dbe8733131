"""The port's kernel modules against the JAX package: the plain PyTorch
versions (what the wrappers run on the CPU) against the JAX oracles and the
interpret-mode Pallas MRI-Q kernel, on the same NumPy inputs.  Tolerances are
those of tests/test_kernels.py: fir 3e-4, mriq 3e-3 (float32 sums taken in
another order; cos/sin of phases up to ~20 rad).

The CUDA kernels themselves run only on a card: see
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JREF
from repro.kernels.mriq import mriq_compute_q as jax_mriq_pallas
from repro_torch.kernels import _build, fir, mriq
from repro_torch.kernels import ref as TREF

FIR_TOL = 3e-4
MRIQ_TOL = 3e-3


def _cnormal(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def _mriq_inputs(rng, num_x, num_k):
    xyz = [rng.standard_normal(num_x).astype(np.float32) for _ in range(3)]
    k = [(rng.standard_normal(num_k) * 0.1).astype(np.float32) for _ in range(3)]
    pm = rng.uniform(size=num_k).astype(np.float32)
    return (*xyz, *k, pm)


@pytest.fixture
def no_cuda_build(monkeypatch):
    """Any attempt to build or load a CUDA library fails the test."""
    def refuse(name):
        raise AssertionError(f"CUDA library {name!r} loaded on a CPU path")
    monkeypatch.setattr(_build, "load", refuse)


# ---------------------------------------------------------------------------
# FIR
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,n,k,block_n,unroll", [
    (2, 256, 16, 128, 1),
    (4, 1024, 64, 256, 1),
    (4, 1024, 64, 512, 4),
    (1, 512, 128, 256, 2),
    (8, 2048, 32, 512, 8),
])
def test_fir_wrapper_on_cpu_matches_jax_fir_ref(no_cuda_build, m, n, k,
                                                block_n, unroll):
    rng = np.random.default_rng(m * n + k)
    x, h = _cnormal(rng, m, n), _cnormal(rng, m, k)
    want = np.asarray(JREF.fir_ref(jnp.asarray(x), jnp.asarray(h)))
    before = fir.fir_filter_bank.launches
    got = fir.fir_filter_bank(torch.from_numpy(x), torch.from_numpy(h),
                              block_n=block_n, tap_unroll=unroll)
    assert fir.fir_filter_bank.launches == before     # plain path: no launch
    np.testing.assert_allclose(got.numpy(), want, rtol=FIR_TOL, atol=FIR_TOL)
    np.testing.assert_allclose(
        TREF.fir_ref(torch.from_numpy(x), torch.from_numpy(h)).numpy(), want,
        rtol=FIR_TOL, atol=FIR_TOL)


def _fir_register_blocked(x, h, block_n, tap_unroll):
    """Plain-torch emulation of csrc/fir.cu: per (bank, tile) the staged
    window ``xs[fir_pad(e)] = x[n0 - K + e]`` (zeros outside [0, N)); thread
    t owns outputs t R .. t R + R - 1 and a register window of R samples
    that slides one sample per tap; taps in order 0 .. K - 1, unrolled by
    ``tap_unroll``, with the kernel's FMAs.  Returns y and how many times
    each output was stored."""
    m, n = x.shape
    k = h.shape[1]
    r, threads = fir.FIR_R, fir.threads(block_n)
    tiles, window = n // block_n, fir.threads(block_n) * fir.FIR_R + k

    pad = fir.fir_pad

    e = torch.arange(window)
    src = torch.arange(tiles)[:, None] * block_n - k + e      # [tiles, window]
    staged = torch.where((src >= 0) & (src < n), x[:, src.clamp(0, n - 1)], 0)
    xs = torch.zeros(m, tiles, int(pad(window - 1)) + 1, dtype=x.dtype)
    xs[:, :, pad(e)] = staged
    assert len(set(pad(e).tolist())) == window           # no two share a slot
    o = torch.arange(threads) * r
    win = xs[:, :, pad(o[:, None] + torch.arange(r) + k)]  # [m, tiles, t, R]
    acc_r = torch.zeros(win.shape)
    acc_i = torch.zeros(win.shape)
    for j0 in range(0, k, tap_unroll):
        for u in range(tap_unroll):
            j = j0 + u
            hr, hi = (v[:, j, None, None, None] for v in (h.real, h.imag))
            nxt = xs[:, :, pad(o + k - 1 - j)]
            acc_r = acc_r + hr * win.real
            acc_r = acc_r - hi * win.imag
            acc_i = acc_i + hr * win.imag
            acc_i = acc_i + hi * win.real
            win = torch.cat([nxt[..., None], win[..., :-1]], dim=-1)
    out = (torch.arange(tiles)[:, None, None] * block_n + o[:, None]
           + torch.arange(r))                              # [tiles, t, R]
    keep = (o[:, None] + torch.arange(r) < block_n).expand_as(out)
    y = torch.zeros(m, n, dtype=x.dtype)
    y[:, out[keep]] = torch.complex(acc_r, acc_i)[:, keep]
    writes = torch.bincount(out[keep], minlength=n)
    return y, writes


@pytest.mark.parametrize("tap_unroll", fir.TAP_UNROLLS)
@pytest.mark.parametrize("k", [8, 64, 128])
@pytest.mark.parametrize("block_n", [128, 256, 500, 512, 1024])
def test_fir_register_blocking_matches_jax_fir_ref(block_n, k, tap_unroll):
    """The kernel's thread-to-output map and sliding register window
    against JAX ``fir_ref`` (3e-4; the same products summed in tap order):
    two tiles per bank, so the second tile's halo reaches into the first;
    every output is stored exactly once (block_n 500 leaves the last
    thread's outputs 500-503 of each tile unstored)."""
    rng = np.random.default_rng(block_n + k)
    x, h = _cnormal(rng, 2, 2 * block_n), _cnormal(rng, 2, k)
    got, writes = _fir_register_blocked(torch.from_numpy(x),
                                        torch.from_numpy(h), block_n,
                                        tap_unroll)
    assert writes.tolist() == [1] * (2 * block_n)
    want = np.asarray(JREF.fir_ref(jnp.asarray(x), jnp.asarray(h)))
    np.testing.assert_allclose(got.numpy(), want, rtol=FIR_TOL, atol=FIR_TOL)


def test_fir_plain_and_ref_match_c_loop_structure():
    rng = np.random.default_rng(0)
    x, h = _cnormal(rng, 3, 48), _cnormal(rng, 3, 8)
    loopy = JREF.fir_ref_loopy(x, h)
    np.testing.assert_array_equal(TREF.fir_ref_loopy(x, h), loopy)
    tx, th = torch.from_numpy(x), torch.from_numpy(h)
    for got in (fir.fir_filter_bank_plain(tx, th), TREF.fir_ref(tx, th)):
        np.testing.assert_allclose(got.numpy(), loopy, rtol=FIR_TOL,
                                   atol=FIR_TOL)


@pytest.mark.parametrize("block_n,unroll,want_block,want_unroll", [
    (384, 1, 256, 1),        # does not divide n=512: largest divisor below
    (1024, 1, 512, 1),       # larger than n
    (512, 3, 512, 2),        # does not divide k=16
    (512, 16, 512, 8),       # divides k but is not instantiated in fir.cu
])
def test_fir_invalid_tiles_are_clamped_with_a_warning(block_n, unroll,
                                                      want_block, want_unroll):
    assert fir.clamp_tiles(512, 16, 512, 1) == (512, 1)      # valid: untouched
    with pytest.warns(UserWarning, match="clamped to"):
        assert fir.clamp_tiles(512, 16, block_n, unroll) == (want_block,
                                                              want_unroll)
    rng = np.random.default_rng(1)
    x, h = _cnormal(rng, 2, 512), _cnormal(rng, 2, 16)
    with pytest.warns(UserWarning, match="clamped to"):
        got = fir.fir_filter_bank(torch.from_numpy(x), torch.from_numpy(h),
                                  block_n=block_n, tap_unroll=unroll)
    np.testing.assert_allclose(got.numpy(), JREF.fir_ref_loopy(x, h),
                               rtol=FIR_TOL, atol=FIR_TOL)


def test_largest_divisor_matches_jax():
    from repro.kernels.fir import largest_divisor as jax_largest_divisor
    for n in (1, 7, 12, 512, 4000):
        for cap in (0, 1, 5, 128, 512, 5000):
            assert fir.largest_divisor(n, cap) == jax_largest_divisor(n, cap)


def test_fir_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 64, dtype=torch.complex64)
    h = torch.zeros(2, 8, dtype=torch.complex64)
    with pytest.raises(TypeError):
        fir.fir_filter_bank(x.to(torch.complex128), h)
    with pytest.raises(ValueError, match="contiguous"):
        fir.fir_filter_bank(torch.zeros(64, 2, dtype=torch.complex64).t(), h)
    with pytest.raises(ValueError):
        fir.fir_filter_bank(x, torch.zeros(3, 8, dtype=torch.complex64))


# ---------------------------------------------------------------------------
# MRI-Q
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("num_x,num_k,bx,bk", [
    (128, 128, 128, 128),
    (300, 200, 128, 128),     # ragged numX and numK
    (1024, 512, 256, 512),
])
def test_mriq_wrapper_on_cpu_matches_jax_ref_and_pallas(no_cuda_build, num_x,
                                                        num_k, bx, bk):
    args = _mriq_inputs(np.random.default_rng(num_x + num_k), num_x, num_k)
    jargs = [jnp.asarray(a) for a in args]
    want_ref = JREF.mriq_ref(*jargs)
    want_pallas = jax_mriq_pallas(*jargs, block_x=bx, block_k=bk,
                                  interpret=True)
    before = mriq.mriq_compute_q.launches
    got = mriq.mriq_compute_q(*(torch.from_numpy(a) for a in args))
    assert mriq.mriq_compute_q.launches == before    # plain path: no launch
    for want in (want_ref, want_pallas):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=MRIQ_TOL, atol=MRIQ_TOL)
    got_ref = TREF.mriq_ref(*(torch.from_numpy(a) for a in args))
    for g, w in zip(got_ref, want_ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=MRIQ_TOL,
                                   atol=MRIQ_TOL)


def test_mriq_ref_matches_c_loop_structure():
    args = _mriq_inputs(np.random.default_rng(2), 40, 24)
    loopy = JREF.mriq_ref_loopy(*args)
    for g, w in zip(TREF.mriq_ref_loopy(*args), loopy):
        np.testing.assert_array_equal(g, w)
    targs = [torch.from_numpy(a) for a in args]
    for got in (TREF.mriq_ref(*targs, chunk=16),
                mriq.mriq_compute_q_plain(*targs)):
        for g, w in zip(got, loopy):
            np.testing.assert_allclose(g.numpy(), w, rtol=MRIQ_TOL,
                                       atol=MRIQ_TOL)


def test_mriq_rejects_what_the_kernel_does_not_take():
    args = [torch.zeros(8) for _ in range(3)] + [torch.zeros(4) for _ in range(4)]
    with pytest.raises(TypeError):
        mriq.mriq_compute_q(*args[:6], args[6].double())
    with pytest.raises(ValueError, match="contiguous"):
        mriq.mriq_compute_q(torch.zeros(16)[::2], *args[1:])
    with pytest.raises(ValueError):
        mriq.mriq_compute_q(torch.zeros(9), *args[1:])
