"""MRI-Q (Parboil) — paper app #2.

The Parboil C source has 16 loop statements (paper §5.1.2).  Pipeline:
ComputePhiMag loop -> ComputeQ (outer voxel loop x inner k-space loop, the
hot nest) -> result checksum loop.  ``ref`` variants mirror the C loop
structure (``fori_loop`` over k-space samples or voxels); ``offload`` is the
blocked outer-product formulation in plain PyTorch; ``hopper`` is the
hand-written CUDA kernel (``kernels/mriq.py``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.paper_apps import MRIQ_BENCH, MRIQ_FULL, MriQConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.loops import fori_loop
from repro_torch.core.program import OffloadableProgram, Region, meta
from repro_torch.core.regions import Impl, dispatch, register_variant
from repro_torch.core.resources import register_smem_estimator
from repro_torch.kernels import mriq as mriq_kernel
from repro_torch.kernels.ref import mriq_ref


# ---------------------------------------------------------------------------
# Region: mriq_phimag  (|phi|^2 loop over k-space samples)
# ---------------------------------------------------------------------------
@register_variant("mriq_phimag", "ref")
def _phimag_ref(phi_r, phi_i):
    def step(j, acc):
        acc[j] = phi_r[j] * phi_r[j] + phi_i[j] * phi_i[j]    # in place
        return acc

    return fori_loop(0, phi_r.shape[0], step, torch.zeros_like(phi_r))


@register_variant("mriq_phimag", "offload")
def _phimag_offload(phi_r, phi_i):
    return phi_r * phi_r + phi_i * phi_i


# ---------------------------------------------------------------------------
# Region: compute_q  (the hot double loop)
# ---------------------------------------------------------------------------
@register_variant("compute_q", "ref")
def _q_ref(x, y, z, kx, ky, kz, pm):
    """Loop-faithful: sequential over k-space samples (C inner loop),
    vectorized over voxels (what a -O3 compiler autovectorizes)."""
    def step(j, acc):
        qr, qi = acc
        ph = 2.0 * math.pi * (kx[j] * x + ky[j] * y + kz[j] * z)
        return qr + pm[j] * torch.cos(ph), qi + pm[j] * torch.sin(ph)

    zero = torch.zeros_like(x)
    return fori_loop(0, kx.shape[0], step, (zero, zero))


@register_variant("compute_q", "offload")
def _q_offload(x, y, z, kx, ky, kz, pm):
    """Blocked outer-product formulation (the kernel's math)."""
    return mriq_ref(x, y, z, kx, ky, kz, pm, chunk=2048)


@register_variant("compute_q", "hopper")
def _q_hopper(x, y, z, kx, ky, kz, pm):
    return mriq_kernel.mriq_compute_q(x, y, z, kx, ky, kz, pm)


@register_smem_estimator("compute_q", "hopper")
def _q_hopper_smem(*_):
    return mriq_kernel.smem_bytes()


# ---------------------------------------------------------------------------
# Region: mriq_check  (result checksum loop)
# ---------------------------------------------------------------------------
@register_variant("mriq_check", "ref")
def _check_ref(qr, qi):
    def step(i, acc):
        return acc + qr[i] * qr[i] + qi[i] * qi[i]

    return fori_loop(0, qr.shape[0], step, qr.new_zeros(()))


@register_variant("mriq_check", "offload")
def _check_offload(qr, qi):
    return torch.sum(qr * qr + qi * qi)


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------
def _pipeline(impl: Impl):
    def run(x, y, z, kx, ky, kz, phi_r, phi_i):
        pm = dispatch("mriq_phimag", impl, phi_r, phi_i)
        qr, qi = dispatch("compute_q", impl, x, y, z, kx, ky, kz, pm)
        chk = dispatch("mriq_check", impl, qr, qi)
        return qr, qi, chk
    return run


def _sample(cfg: MriQConfig):
    def make(seed: int, device: torch.device):
        # drawn on the CPU generator, so a seed gives the same inputs on
        # every device
        g = torch.Generator().manual_seed(seed)
        x, y, z = (torch.randn(cfg.num_x, generator=g) for _ in range(3))
        kx, ky, kz = (torch.randn(cfg.num_k, generator=g) * 0.1
                      for _ in range(3))
        phi_r = torch.randn(cfg.num_k, generator=g)
        phi_i = torch.randn(cfg.num_k, generator=g)
        return tuple(a.to(device) for a in (x, y, z, kx, ky, kz, phi_r, phi_i))
    return make


def make_program(cfg: MriQConfig = MRIQ_BENCH,
                 analysis_cfg: MriQConfig = MRIQ_FULL,
                 device=None) -> OffloadableProgram:
    """MRI-Q sampled at ``cfg`` and analysed at ``analysis_cfg``, run on
    ``device`` (default ``cuda``)."""
    fx = meta((analysis_cfg.num_x,), torch.float32)
    fk = meta((analysis_cfg.num_k,), torch.float32)
    regions = [
        Region("mriq_phimag", _phimag_ref, (fk, fk)),
        Region("compute_q", _q_ref, (fx, fx, fx, fk, fk, fk, fk)),
        Region("mriq_check", _check_ref, (fx, fx)),
    ]
    return OffloadableProgram(
        name="mriq",
        regions=regions,
        build=_pipeline,
        sample_inputs=_sample(cfg),
        device=resolve_device(device),
        source_loop_count=16,
        description="Parboil MRI-Q (paper app #2)",
    )
