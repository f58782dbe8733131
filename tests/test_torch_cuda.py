"""The CUDA kernels against their plain PyTorch versions, on the card.

Skipped without one (the decision is made in a fixture).  This file
imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import fir, mriq
from repro_torch.kernels import flash_attention as FA

FIR_TOL = 3e-4
MRIQ_TOL = 3e-3
# attention: bf16 2e-2, float32 2e-5 (flash) and 5e-6 (decode), the
# tolerances of tests/test_kernels.py
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
DECODE_TOL = {torch.bfloat16: 2e-2, torch.float32: 5e-6}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _cnormal(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,block_n,unroll", [
    (4, 1024, 64, 512, 1),
    (64, 4000, 128, 500, 4),     # N no power of two (500 divides it)
    (2, 256, 8, 128, 8),
])
def test_fir_kernel_matches_plain_on_cuda(cuda_device, m, n, k, block_n, unroll):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_cnormal(rng, m, n)).to(cuda_device)
    h = torch.from_numpy(_cnormal(rng, m, k)).to(cuda_device)
    before = fir.fir_filter_bank.launches
    got = fir.fir_filter_bank(x, h, block_n=block_n, tap_unroll=unroll)
    torch.cuda.synchronize()
    assert fir.fir_filter_bank.launches == before + 1
    torch.testing.assert_close(got, fir.fir_filter_bank_plain(x, h),
                               rtol=FIR_TOL, atol=FIR_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("num_x,num_k", [(300, 200), (4096, 2048), (1, 1)])
def test_mriq_kernel_matches_plain_on_cuda(cuda_device, num_x, num_k):
    rng = np.random.default_rng(4)
    xyz = [rng.standard_normal(num_x) for _ in range(3)]
    ks = [rng.standard_normal(num_k) * 0.1 for _ in range(3)]
    args = [torch.tensor(a, dtype=torch.float32, device=cuda_device)
            for a in (*xyz, *ks, rng.uniform(size=num_k))]
    before = mriq.mriq_compute_q.launches
    got = mriq.mriq_compute_q(*args)
    torch.cuda.synchronize()
    assert mriq.mriq_compute_q.launches == before + 1
    for g, w in zip(got, mriq.mriq_compute_q_plain(*args)):
        torch.testing.assert_close(g, w, rtol=MRIQ_TOL, atol=MRIQ_TOL)


@pytest.mark.cuda
def test_kernels_refuse_mixed_devices(cuda_device):
    x = torch.zeros(2, 64, dtype=torch.complex64, device=cuda_device)
    with pytest.raises(ValueError):
        fir.fir_filter_bank(x, torch.zeros(2, 8, dtype=torch.complex64))


def _normal(rng, shape, dtype, device):
    return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=device).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,d,dtype,window,bq,bk", [
    (1, 32, 8, 2080, 128, torch.bfloat16, 0, 64, 64),     # largest bucket
    (1, 32, 8, 2080, 128, torch.bfloat16, 512, 128, 32),  # windowed
    (2, 4, 2, 128, 16, torch.bfloat16, 0, 32, 128),       # planner's shape
    (1, 8, 2, 300, 64, torch.float32, 48, 64, 64),        # ragged, f32
    (1, 32, 8, 8, 128, torch.bfloat16, 0, 64, 64),        # smallest bucket
])
def test_flash_kernel_matches_plain_on_cuda(cuda_device, b, hq, hkv, s, d,
                                            dtype, window, bq, bk):
    rng = np.random.default_rng(s + d)
    q = _normal(rng, (b, hq, s, d), dtype, cuda_device)
    k = _normal(rng, (b, hkv, s, d), dtype, cuda_device)
    v = _normal(rng, (b, hkv, s, d), dtype, cuda_device)
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, window=window, block_q=bq, block_k=bk)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    want = FA.flash_attention_plain(q, k, v, window=window)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,d,dtype,window,bk", [
    (4, 32, 8, 2080, 128, torch.bfloat16, 0, 128),
    (4, 32, 8, 2080, 128, torch.bfloat16, 300, 64),
    (2, 8, 2, 512, 64, torch.float32, 0, 256),
    (3, 4, 2, 100, 16, torch.float32, 20, 128),
])
def test_decode_kernel_matches_plain_on_cuda(cuda_device, b, hq, hkv, s, d,
                                             dtype, window, bk):
    rng = np.random.default_rng(s)
    q = _normal(rng, (b, hq, 1, d), dtype, cuda_device)
    k = _normal(rng, (b, hkv, s, d), dtype, cuda_device)
    v = _normal(rng, (b, hkv, s, d), dtype, cuda_device)
    sp = torch.arange(s, dtype=torch.int32, device=cuda_device).repeat(b, 1)
    sp[0, s // 3:] = -1                                   # empty slots
    cur = torch.full((b,), s - 1, dtype=torch.int32, device=cuda_device)
    cur[0] = s // 3 - 1
    before = DA.decode_attention.launches
    got = DA.decode_attention(q, k, v, sp, cur, window=window, block_k=bk)
    torch.cuda.synchronize()
    assert DA.decode_attention.launches == before + 1
    want = DA.decode_attention_plain(q, k, v, sp, cur, window=window)
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "noncontig"])
def test_attention_wrappers_raise_on_cuda(cuda_device, bad):
    rng = np.random.default_rng(0)
    dt = torch.float16 if bad == "dtype" else torch.bfloat16
    q = _normal(rng, (1, 4, 32, 16), dt, cuda_device)
    k = _normal(rng, (1, 2, 32, 16), dt, cuda_device)
    v = _normal(rng, (1, 2, 32, 16), dt, cuda_device)
    qd = _normal(rng, (1, 4, 1, 16), dt, cuda_device)
    sp = torch.arange(32, dtype=torch.int32, device=cuda_device)[None]
    cur = torch.tensor([31], dtype=torch.int32, device=cuda_device)
    if bad == "noncontig":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    flash_before = FA.flash_attention.launches
    decode_before = DA.decode_attention.launches
    with pytest.raises((TypeError, ValueError)):
        FA.flash_attention(q, k, v)
    with pytest.raises((TypeError, ValueError)):
        DA.decode_attention(qd, k, v, sp, cur)
    assert FA.flash_attention.launches == flash_before
    assert DA.decode_attention.launches == decode_before
