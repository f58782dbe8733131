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


def test_flash_tuning_space_fits_hopper_shared_memory():
    space = tuning_space("attn_core", "hopper")
    q = torch.empty((1, 32, 4096, 128), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((1, 8, 4096, 128), dtype=torch.bfloat16, device="meta")
    points = space.points((q, kv, kv))
    assert {"block_q": 128, "block_k": 128} not in points    # 269 KB
    assert len(points) == len(FA.BLOCK_QS) * len(FA.BLOCK_KS) - 1
    assert all(FA.smem_bytes(p["block_q"], p["block_k"], 128)
               <= SMEM_PER_BLOCK for p in points)
    # the JAX genes were sized for VMEM: its largest tile would not fit
    assert FA.smem_bytes(512, 1024, 128) > SMEM_PER_BLOCK
    est = precompile("attn_core", "hopper", variants("attn_core")["hopper"],
                     (q, kv, kv), params={"block_q": 128, "block_k": 64})
    assert est.lower_ok and est.resource_bytes == FA.smem_bytes(128, 64, 128)


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


def test_decode_tuning_space_and_estimate():
    space = tuning_space("decode_attn", "hopper")
    f32 = torch.float32

    def args(hq, hkv, s, d):
        return (torch.empty((2, hq, 1, d), dtype=f32, device="meta"),
                torch.empty((2, hkv, s, d), dtype=f32, device="meta"),
                torch.empty((2, hkv, s, d), dtype=f32, device="meta"),
                torch.empty((2, s), dtype=torch.int32, device="meta"),
                torch.empty((2,), dtype=torch.int32, device="meta"))

    assert space.size(args(8, 2, 512, 64)) == 3
    # a 256-slot k+v tile of head_dim 128 is 270 KB: over Hopper's limit
    assert {"block_k": 256} not in space.points(args(32, 8, 2080, 128))
    est = precompile("decode_attn", "hopper", variants("decode_attn")["hopper"],
                     args(8, 2, 512, 64))
    assert est.lower_ok and est.resource_bytes == DA.smem_bytes(4, 64, 128)
