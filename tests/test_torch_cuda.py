"""The CUDA kernels against their plain PyTorch versions, on the card.

Skipped without one (the decision is made in a fixture).  This file
imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fir, mriq

FIR_TOL = 3e-4
MRIQ_TOL = 3e-3


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
