"""Paper reproduction, app #2 on the port: automatic offload of Parboil
MRI-Q (paper §5, Fig. 4 row 2; the twin of ``examples/offload_mriq.py``).
The same staged pipeline as ``offload_fir``: planned with the paper's
budgets, then, on a card, the ``hopper`` kernel (``csrc/mriq.cu``) held
against ``mriq_ref`` and an H100 roofline projection of the hot loop.

    PYTHONPATH=src python -m repro_torch.launch.offload_mriq \\
        [--strategy surrogate] [--device cpu --reduced]

By default the planner samples 16,384 voxels x 512 k-space samples and
analyses Parboil "large" (262,144 x 2,048); ``--reduced`` plans 300 x 200,
for the CPU.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.apps.mriq import make_program
from repro_torch.configs.paper_apps import MRIQ_BENCH, MRIQ_FULL, MriQConfig
from repro_torch.core.device import resolve_device
from repro_torch.kernels.mriq import mriq_compute_q
from repro_torch.kernels.ref import mriq_ref
from repro_torch.launch.constants import PEAK_FLOPS_FP32, projected_seconds
from repro_torch.launch.offload_fir import plan, planner_args, validate

PAPER_SPEEDUP = 7.1          # Intel PAC Arria10 GX vs Xeon Bronze 3104
TOL = 3e-3                   # mriq_compute_q's tolerance in tests/test_kernels.py
REDUCED = MriQConfig(num_x=300, num_k=200)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    planner_args(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sample, full = (REDUCED, REDUCED) if args.reduced else (MRIQ_BENCH,
                                                           MRIQ_FULL)

    print("=== MRI-Q automatic offload (paper app #2) ===")
    report = plan(make_program(sample, full, device=dev), args)
    print(report.summary())

    def pairs():
        g = torch.Generator().manual_seed(0)
        x, y, z = (torch.randn(512, generator=g).to(dev) for _ in range(3))
        kx, ky, kz = (torch.randn(256, generator=g).to(dev) * 0.1
                      for _ in range(3))
        pm = torch.rand(256, generator=g).to(dev)
        got = mriq_compute_q(x, y, z, kx, ky, kz, pm)
        want = mriq_ref(x, y, z, kx, ky, kz, pm)
        yield from zip(got, want)

    err = validate("mriq_compute_q", dev, pairs, TOL)

    print("\n--- H100 roofline projection for the selected hot loop ---")
    transcendentals = 2.0 * full.num_x * full.num_k       # sin + cos per pair
    bytes_moved = 4.0 * (3 * full.num_x + 4 * full.num_k + 2 * full.num_x)
    proj = projected_seconds(full.flops, bytes_moved, transcendentals,
                             peak_flops=PEAK_FLOPS_FP32)
    print(f"paper speedup (Arria10 FPGA vs Xeon):   {PAPER_SPEEDUP}x")
    print(f"measured on {report.backend}: {report.speedup:.2f}x")
    print(f"projected H100 kernel time at {full.num_x} x {full.num_k}: "
          f"{proj['seconds'] * 1e6:.3f} us ({proj['bound']}-bound, published "
          f"peaks at 700 W) vs all-ref baseline "
          f"{report.baseline.run_seconds * 1e3:.2f} ms on {report.backend} "
          f"(sample {sample.num_x} x {sample.num_k})")
    return {"report": report, "max_abs_err": err, "projection": proj}


if __name__ == "__main__":
    main()
