"""Step 3 of the port: a hand-written kernel's variant reports the shared
memory per block of the launch it would make (the tile of a tuned gene
included) against Hopper's per-block limit; a plain-PyTorch variant reports
its largest live intermediate against the L2 cache."""
import pytest
import torch

from repro_torch.apps import mriq, tdfir  # noqa: F401 — registers the variants
from repro_torch.configs.paper_apps import MRIQ_FULL, TDFIR_FULL
from repro_torch.core.program import meta
from repro_torch.core.regions import variants
from repro_torch.core.resources import L2_BYTES, precompile
from repro_torch.kernels import SMEM_PER_BLOCK
from repro_torch.kernels import mriq as mriq_kernel
from repro_torch.kernels.fir import smem_bytes


def _fir_args(n_samples=TDFIR_FULL.n_samples):
    return (meta((TDFIR_FULL.n_banks, n_samples), torch.complex64),
            meta((TDFIR_FULL.n_banks, TDFIR_FULL.n_taps), torch.complex64))


@pytest.mark.parametrize("block_n", [128, 256, 512, 1024])
def test_fir_hopper_estimate_follows_the_gene_tile(block_n):
    est = precompile("fir_bank", "hopper", variants("fir_bank")["hopper"],
                     _fir_args(), {"block_n": block_n, "tap_unroll": 4})
    assert est.lower_ok, est.error
    assert est.resource_bytes == smem_bytes(block_n, TDFIR_FULL.n_taps)
    assert est.resource_budget == SMEM_PER_BLOCK


def test_fir_hopper_estimate_uses_the_clamped_tile():
    with pytest.warns(UserWarning, match="clamped to 500"):
        est = precompile("fir_bank", "hopper", variants("fir_bank")["hopper"],
                         _fir_args(4000), {"block_n": 512})
    assert est.resource_bytes == smem_bytes(500, TDFIR_FULL.n_taps)


def test_mriq_hopper_estimate_is_the_staged_chunk():
    fx = meta((MRIQ_FULL.num_x,), torch.float32)
    fk = meta((MRIQ_FULL.num_k,), torch.float32)
    est = precompile("compute_q", "hopper", variants("compute_q")["hopper"],
                     (fx, fx, fx, fk, fk, fk, fk))
    assert est.lower_ok, est.error
    assert est.resource_bytes == mriq_kernel.smem_bytes() == 16 * 1024
    assert est.resource_budget == SMEM_PER_BLOCK


def test_plain_variant_estimate_is_its_largest_intermediate():
    est = precompile("fir_bank", "offload", variants("fir_bank")["offload"],
                     _fir_args())
    assert est.lower_ok, est.error
    assert est.resource_budget == L2_BYTES
    # the causally padded row [M, N + K - 1] complex64 is the largest
    m, n, k = TDFIR_FULL.n_banks, TDFIR_FULL.n_samples, TDFIR_FULL.n_taps
    assert est.resource_bytes == 8 * m * (n + k - 1)
