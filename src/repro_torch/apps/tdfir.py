"""Time-domain FIR filter bank (HPEC challenge tdFIR) — paper app #1.

The HPEC C source has 36 loop statements (paper §5.1.2); the pipeline has
one offloadable region per loop nest that matters, each with a
loop-faithful ``ref`` variant (structured like the C loops: ``fori_loop``
over banks or taps) and a restructured ``offload`` variant in plain
PyTorch.  The hot region ``fir_bank`` also has the ``hopper`` variant, the
hand-written CUDA kernel (``kernels/fir.py``).

Pipeline: load/scale input -> FIR bank (the hot triple loop) -> output
scaling -> per-bank energy verification.

The ``ref`` loops update their accumulator in place (one row per
iteration) instead of copying it, as ``.at[].set`` would: the loop stays
O(row) per iteration.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_apps import TDFIR_FULL, TdFirConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.loops import fori_loop
from repro_torch.core.program import OffloadableProgram, Region, meta
from repro_torch.core.regions import Impl, TuningSpace, dispatch, register_variant
from repro_torch.core.resources import register_smem_estimator
from repro_torch.kernels import SMEM_PER_BLOCK
from repro_torch.kernels.fir import (DEFAULT_BLOCK_N, MAX_BLOCK_N,
                                     fir_filter_bank, largest_divisor,
                                     smem_bytes)
from repro_torch.kernels.ref import fir_ref


# ---------------------------------------------------------------------------
# Region: fir_load  (input conditioning loop over banks)
# ---------------------------------------------------------------------------
@register_variant("fir_load", "ref")
def _load_ref(x):
    def bank(i, acc):
        row = x[i:i + 1]
        acc[i:i + 1] = row * (1.0 / torch.sqrt((row.abs() ** 2).mean() + 1e-9))
        return acc

    return fori_loop(0, x.shape[0], bank, torch.zeros_like(x))


@register_variant("fir_load", "offload")
def _load_offload(x):
    scale = 1.0 / torch.sqrt((x.abs() ** 2).mean(dim=1, keepdim=True) + 1e-9)
    return x * scale


# ---------------------------------------------------------------------------
# Region: fir_bank  (the hot loop: banks x samples x taps)
# ---------------------------------------------------------------------------
@register_variant("fir_bank", "ref")
def _fir_ref(x, h):
    return fir_ref(x, h)          # fori over taps (loop-faithful)


@register_variant("fir_bank", "offload")
def _fir_offload(x, h):
    """Restructured with the paper's own speedup technique: FULL loop
    unrolling of the tap loop (paper §3.3 'loop unrolling', knob b -> K).
    Every tap becomes a static shifted MAC."""
    n = x.shape[1]
    k = h.shape[1]
    xp = F.pad(x, (k - 1, 0))
    acc = torch.zeros_like(x)
    for j in range(k):                      # unrolled in Python
        acc = acc + h[:, j:j + 1] * xp[:, k - 1 - j:k - 1 - j + n]
    return acc


def _fir_tile_ok(p, args) -> bool:
    """fir_bank tile legality: block_n divides the sample count (and needs
    at most the kernel's 256 threads), tap_unroll divides the tap count,
    and the block's shared memory (taps + halo'd x window, complex64) fits
    a Hopper block.  Unbound queries (no args) accept every point."""
    if not args:
        return True
    try:
        n, k = args[0].shape[1], args[1].shape[1]
    except (IndexError, AttributeError):
        return True
    bn, tu = p["block_n"], p["tap_unroll"]
    return (bn <= n and n % bn == 0 and tu <= k and k % tu == 0
            and bn <= MAX_BLOCK_N and smem_bytes(bn, k) <= SMEM_PER_BLOCK)


@register_variant("fir_bank", "hopper", tuning=TuningSpace(
    axes={"block_n": (128, 256, 512, 1024), "tap_unroll": (1, 2, 4, 8)},
    defaults={"block_n": DEFAULT_BLOCK_N, "tap_unroll": 1},
    validity=_fir_tile_ok))
def _fir_hopper(x, h, *, block_n=DEFAULT_BLOCK_N, tap_unroll=1):
    return fir_filter_bank(x, h, block_n=block_n, tap_unroll=tap_unroll)


@register_smem_estimator("fir_bank", "hopper")
def _fir_hopper_smem(x, h, *, block_n=DEFAULT_BLOCK_N, tap_unroll=1):
    # the tile the kernel runs with: the wrapper clamps block_n to a divisor
    return smem_bytes(largest_divisor(x.shape[1], block_n), h.shape[1])


# ---------------------------------------------------------------------------
# Region: fir_scale  (output normalization loop)
# ---------------------------------------------------------------------------
@register_variant("fir_scale", "ref")
def _scale_ref(y):
    def bank(i, acc):
        acc[i:i + 1] = y[i:i + 1] * (1.0 / y.shape[1])
        return acc

    return fori_loop(0, y.shape[0], bank, torch.zeros_like(y))


@register_variant("fir_scale", "offload")
def _scale_offload(y):
    return y * (1.0 / y.shape[1])


# ---------------------------------------------------------------------------
# Region: fir_energy  (verification loop: per-bank output energy)
# ---------------------------------------------------------------------------
@register_variant("fir_energy", "ref")
def _energy_ref(y):
    def bank(i, acc):
        acc[i] = torch.sum(y[i:i + 1].abs() ** 2)
        return acc

    m = y.shape[0]
    return fori_loop(0, m, bank, torch.zeros(m, dtype=torch.float32,
                                             device=y.device))


@register_variant("fir_energy", "offload")
def _energy_offload(y):
    return torch.sum(y.abs() ** 2, dim=1).to(torch.float32)


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------
def _pipeline(impl: Impl):
    def run(x, h):
        x = dispatch("fir_load", impl, x)
        y = dispatch("fir_bank", impl, x, h)
        y = dispatch("fir_scale", impl, y)
        e = dispatch("fir_energy", impl, y)
        return y, e
    return run


def _sample(cfg: TdFirConfig):
    def make(seed: int, device: torch.device):
        # drawn on the CPU generator, so a seed gives the same inputs on
        # every device; re and im are independent draws
        g = torch.Generator().manual_seed(seed)

        def cnormal(*shape):
            return torch.complex(torch.randn(shape, generator=g),
                                 torch.randn(shape, generator=g))

        x = cnormal(cfg.n_banks, cfg.n_samples)
        h = cnormal(cfg.n_banks, cfg.n_taps)
        return x.to(device), h.to(device)
    return make


def make_program(cfg: TdFirConfig = TDFIR_FULL,
                 analysis_cfg: TdFirConfig = TDFIR_FULL,
                 device=None) -> OffloadableProgram:
    """tdFIR sampled at ``cfg`` and analysed at ``analysis_cfg``, run on
    ``device`` (default ``cuda``)."""
    x_abs = meta((analysis_cfg.n_banks, analysis_cfg.n_samples), torch.complex64)
    h_abs = meta((analysis_cfg.n_banks, analysis_cfg.n_taps), torch.complex64)
    regions = [
        Region("fir_load", _load_ref, (x_abs,)),
        Region("fir_bank", _fir_ref, (x_abs, h_abs)),
        Region("fir_scale", _scale_ref, (x_abs,)),
        Region("fir_energy", _energy_ref, (x_abs,)),
    ]
    return OffloadableProgram(
        name="tdfir",
        regions=regions,
        build=_pipeline,
        sample_inputs=_sample(cfg),
        device=resolve_device(device),
        source_loop_count=36,
        description="HPEC time-domain FIR filter bank (paper app #1)",
    )
