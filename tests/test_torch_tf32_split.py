"""The float32 flash body's arithmetic (``csrc/flash_attention.cu``,
``flash_tf32_kernel``) emulated in plain PyTorch and held against the JAX
oracle ``kernels/ref.py::attention_ref`` at the flash tolerance, 2e-5.

The kernel runs both products of attention on TF32 tensor cores as split
products: x = hi + lo with hi = x rounded as cvt.rna.tf32.f32 rounds and
lo = x - hi, which the tensor cores read truncated to TF32, and a.b =
hi.hi + hi.lo + lo.hi in float32.  The emulation follows its tile schedule
(kv tiles of block_k keys, a warpgroup per 64 query rows, the skips and
edge masks, the online softmax in log2 units).  A single TF32 product does
not hold 2e-5, which is why the split is there.  The Pallas flash kernel
raises under this jax version, so the oracle is its dense reference.

Also: the float32 tile points of the wrapper (``fits``, ``smem_bytes``,
``threads``, ``default_tiles``) against Hopper's limits."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JREF
from repro_torch.kernels import SMEM_PER_BLOCK
from repro_torch.kernels import flash_attention as FA

FLASH_TOL = 2e-5
NEG_INF = -1e30
LOG2E = float(np.log2(np.e))


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: keep 10 mantissa bits, rounding the low 13 to
    nearest with ties away from zero (on the magnitude bits, so for either
    sign), the low 13 bits then zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """A float32 read as a .tf32 operand: the low 13 mantissa bits
    dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split: hi rounded to nearest, lo = x - hi (exact in
    float32) as the tensor cores read it."""
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)


def product(eq: str, a: torch.Tensor, b: torch.Tensor, mode: str):
    """``einsum(eq, a, b)`` as the tensor cores take it: ``3xtf32`` the two
    cross terms then hi.hi, ``tf32`` one product of operands rounded to
    nearest."""
    if mode == "tf32":
        return torch.einsum(eq, tf32_rna(a), tf32_rna(b))
    ah, al = split(a)
    bh, bl = split(b)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def flash_tf32(q, k, v, *, causal, window, block_q, block_k, mode="3xtf32"):
    """What ``flash_tf32_kernel`` computes, tile by tile: per q tile the kv
    tiles its skip rule admits; per warpgroup (64 rows) the tiles not
    wholly masked for its rows; S = (q * 1/sqrt(D)) K^T, the mask only on a
    tile at an edge of the warpgroup's rows, p = exp2(s log2 e - m) with
    the finite NEG_INF, O += P V, o = acc / max(l, 1e-30)."""
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    kf = k.repeat_interleave(g, dim=1)
    vf = v.repeat_interleave(g, dim=1)
    qs = q * np.float32(1.0 / np.sqrt(d))
    n_tiles = -(-s // block_k)
    out = torch.zeros((b, hq, s, d))
    for q0 in range(0, s, block_q):
        kt_end = min(n_tiles, -(-(q0 + block_q) // block_k)) if causal \
            else n_tiles
        kt_begin = (q0 - window + 1) // block_k \
            if window and q0 - window + 1 > 0 else 0
        for r0 in range(q0, min(q0 + block_q, s), 64):    # a warpgroup's
            rows = torch.arange(r0, min(r0 + 64, s))
            m = torch.full((b, hq, len(rows)), NEG_INF)
            l = torch.zeros((b, hq, len(rows)))
            acc = torch.zeros((b, hq, len(rows), d))
            for kt in range(kt_begin, kt_end):
                k0 = kt * block_k
                if (causal and k0 > r0 + 63) or (
                        window and k0 + block_k - 1 <= r0 - window):
                    continue
                keys = torch.arange(k0, min(k0 + block_k, s))
                sc = product("bhqd,bhkd->bhqk", qs[:, :, rows],
                             kf[:, :, keys], mode) * LOG2E
                if (k0 + block_k > s or (causal and k0 + block_k - 1 > r0)
                        or (window and k0 <= r0 + 63 - window)):
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
                acc = acc * alpha[..., None] + product(
                    "bhqk,bhkd->bhqd", p, vf[:, :, keys], mode)
                m = mn
            out[:, :, rows] = acc / l.clamp_min(1e-30)[..., None]
    return out


def _qkv(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


def _oracle(q, k, v, causal, window):
    return np.array(JREF.attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window), np.float32)


def _max_excess(got: torch.Tensor, want: np.ndarray, tol: float) -> float:
    """max(|got - want| - tol * |want|): at most ``tol`` when got holds
    rtol = atol = tol."""
    w = torch.from_numpy(want)
    return float(((got - w).abs() - tol * w.abs()).max())


# phase 3's float32 shapes of chip_smoke.py, cut to a few heads, at S = 300
# (no multiple of any tile) and the default tiles of the head width
SHAPES = [(1, 4, 2, 16), (1, 4, 2, 64), (1, 4, 1, 128), (1, 2, 1, 256)]


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                       # TF32's step at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + ulp * 0.75, 3.0, 0.0], dtype=torch.float32)
    want = [one + ulp, -(one + ulp), one, one + ulp, 3.0, 0.0]
    assert tf32_rna(x).tolist() == want
    assert tf32_trunc(x).tolist() == [one, -one, one, one, 3.0, 0.0]
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    hi, lo = split(y)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    # hi + lo keeps ~21 bits of y (lo's truncation: < 2^-11 of lo, which
    # is at most half of hi's last place); hi alone ~11
    rel = ((hi + lo - y).abs() / y.abs()).max()
    assert rel < 2.0 ** -20
    assert ((hi - y).abs() / y.abs()).max() > 2.0 ** -14


@pytest.mark.parametrize("window", [0, 48], ids=["causal", "window48"])
@pytest.mark.parametrize("b,hq,hkv,d", SHAPES, ids=[f"D{s[3]}" for s in SHAPES])
def test_split_tf32_flash_holds_the_float32_tolerance(b, hq, hkv, d, window):
    s = 300
    q, k, v = _qkv(s + d + window, b, hq, hkv, s, d)
    bq, bk = FA.default_tiles(torch.float32, d)
    got = flash_tf32(*(torch.from_numpy(t) for t in (q, k, v)), causal=True,
                     window=window, block_q=bq, block_k=bk)
    want = _oracle(q, k, v, True, window)
    np.testing.assert_allclose(got.numpy(), want, rtol=FLASH_TOL,
                               atol=FLASH_TOL)
    # and the same at the wrapper's other float32 tile points
    for pq, pk in itertools.product(FA.BLOCK_QS, FA.BLOCK_KS):
        if (pq, pk) == (bq, bk) or not FA.fits(pq, pk, d, torch.float32):
            continue
        other = flash_tf32(*(torch.from_numpy(t) for t in (q, k, v)),
                           causal=True, window=window, block_q=pq, block_k=pk)
        assert _max_excess(other, want, FLASH_TOL) <= FLASH_TOL


def test_a_single_tf32_product_misses_the_float32_tolerance():
    b, hq, hkv, d, s = 1, 4, 1, 128, 300
    q, k, v = _qkv(7, b, hq, hkv, s, d)
    want = _oracle(q, k, v, True, 0)
    bq, bk = FA.default_tiles(torch.float32, d)
    args = [torch.from_numpy(t) for t in (q, k, v)]
    one = flash_tf32(*args, causal=True, window=0, block_q=bq, block_k=bk,
                     mode="tf32")
    three = flash_tf32(*args, causal=True, window=0, block_q=bq, block_k=bk)
    assert _max_excess(one, want, FLASH_TOL) > FLASH_TOL
    assert _max_excess(three, want, FLASH_TOL) <= FLASH_TOL
    # by an order of magnitude: the split is what holds float32
    err_one = float((one - torch.from_numpy(want)).abs().max())
    err_three = float((three - torch.from_numpy(want)).abs().max())
    assert err_one > 10 * err_three


@pytest.mark.parametrize("d", FA.HEAD_DIMS)
def test_float32_tile_points_fit_hopper(d):
    f32 = torch.float32
    points = [(bq, bk) for bq, bk in itertools.product(FA.BLOCK_QS,
                                                       FA.BLOCK_KS)
              if FA.fits(bq, bk, d, f32)]
    assert points
    assert {(d, bq, bk) for bq, bk in points} == {
        p for p in FA.F32_POINTS if p[0] == d}
    for bq, bk in points:
        assert FA.smem_bytes(bq, bk, d, f32) <= SMEM_PER_BLOCK
        # a consumer warpgroup per 64 rows and the producer warpgroup
        assert FA.threads(bq, d, f32) == bq // 64 * 128 + 128 <= 384
    assert FA.default_tiles(f32, d) in points
    # the largest tile that fits, the larger block_q first
    assert FA.default_tiles(f32, d) == max(points,
                                           key=lambda p: (p[0] * p[1], p[0]))


# the ring: 16 * block_k * D bytes a stage (K hi, K lo, V^T hi, V^T lo),
# two stages where they fit, else one; the raw Q tile 4 * block_q * (D + 4);
# 1,024 bytes of alignment room and 128 of barriers
@pytest.mark.parametrize("d,bq,bk,stages", [
    (16, 128, 64, 2), (64, 128, 64, 2), (128, 128, 32, 2), (128, 64, 64, 1),
    (256, 64, 32, 1),
])
def test_float32_shared_memory_is_the_ring_and_the_q_tile(d, bq, bk, stages):
    n = stages * 16 * bk * d + 4 * bq * (d + 4) + 1024 + 128
    assert FA.smem_bytes(bq, bk, d, torch.float32) == n
    assert FA.fits(bq, bk, d, torch.float32)
    if stages == 1:
        assert n + 16 * bk * d > SMEM_PER_BLOCK
