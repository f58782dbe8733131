"""Paper reproduction, app #1 on the port: automatic offload of the HPEC
time-domain FIR filter bank (paper §5, Fig. 4 row 1; the twin of
``examples/offload_fir.py``).

Runs the full staged pipeline with the paper's budgets (a=5, c=3, d<=4) and
prints every intermediate the paper records: loop census, per-loop
arithmetic intensity, resource fractions, resource efficiency, the measured
patterns and the selected solution.  Then, on a card, the ``hopper`` kernel
(``csrc/fir.cu``) held against ``fir_ref`` at the tolerance of
``tests/test_kernels.py``, and an H100 roofline projection of the hot loop
from ``launch/constants.py``.  On the CPU the kernel is not run: a CUDA
kernel has no CPU mode.

    PYTHONPATH=src python -m repro_torch.launch.offload_fir \\
        [--strategy surrogate] [--tune-tiles] [--device cpu --reduced]

The default size is HPEC set 1 (64 banks x 128 taps x 4,096 samples);
``--reduced`` plans 4 x 16 x 256, for the CPU.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.apps.tdfir import make_program
from repro_torch.configs.paper_apps import TDFIR_FULL, TdFirConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.planner import AutoOffloader, PlannerConfig
from repro_torch.core.strategies import STRATEGY_NAMES
from repro_torch.kernels.fir import fir_filter_bank
from repro_torch.kernels.ref import fir_ref
from repro_torch.launch.constants import PEAK_FLOPS_FP32, projected_seconds

PAPER_SPEEDUP = 4.0          # Intel PAC Arria10 GX vs Xeon Bronze 3104
TOL = 3e-4                   # fir_filter_bank's tolerance in tests/test_kernels.py
REDUCED = TdFirConfig(n_banks=4, n_taps=16, n_samples=256)


def planner_args(ap: argparse.ArgumentParser) -> None:
    """The options both paper-app launchers take."""
    ap.add_argument("--strategy", default="staged",
                    choices=list(STRATEGY_NAMES),
                    help="Step-4 search strategy (part of the plan-cache "
                         "key); surrogate = roofline-predicted fitness, auto "
                         "= pick by space size")
    ap.add_argument("--seed", type=int, default=0,
                    help="strategy RNG seed (GA)")
    ap.add_argument("--tune-tiles", action="store_true",
                    help="search (variant, tile params) genes for variants "
                         "declaring a TuningSpace; part of the plan-cache key")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--reduced", action="store_true",
                    help="plan the app at a small size (for the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")


def plan(program, args):
    return AutoOffloader(PlannerConfig(
        reps=args.reps, strategy=args.strategy, seed=args.seed,
        tune_tiles=args.tune_tiles)).plan(program, cache=PlanCache.default())


def validate(name: str, dev: torch.device, run, tol: float):
    """Hold the hopper kernel against its oracle on ``dev``: ``run()``
    returns pairs (kernel output, oracle output).  Returns the max abs
    error, or None when ``dev`` is no card (the kernel is not run)."""
    print(f"\n--- deploy kernel validation ({name}, hopper) ---")
    if dev.type != "cuda":
        print(f"hopper not run on {dev}: the CUDA kernel runs only on a "
              "card, and no plain version is timed or checked in its place")
        return None
    err = 0.0
    for got, want in run():
        torch.cuda.synchronize(dev)
        if not torch.allclose(got, want, rtol=tol, atol=tol):
            raise AssertionError(f"{name}: hopper differs from its oracle by "
                                 f"{float((got - want).abs().max()):.3e} "
                                 f"(rtol=atol={tol})")
        err = max(err, float((got - want).abs().max()))
    print(f"hopper-vs-ref max abs err: {err:.2e} (PASS, rtol=atol={tol})")
    return err


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    planner_args(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = REDUCED if args.reduced else TDFIR_FULL

    print("=== tdFIR automatic offload (paper app #1) ===")
    report = plan(make_program(cfg, cfg, device=dev), args)
    print(report.summary())

    def pairs():
        g = torch.Generator().manual_seed(0)

        def cnormal(*shape):
            return torch.complex(torch.randn(shape, generator=g),
                                 torch.randn(shape, generator=g)).to(dev)

        x, h = cnormal(8, 1024), cnormal(8, 64)
        yield fir_filter_bank(x, h, block_n=512), fir_ref(x, h)

    err = validate("fir_filter_bank", dev, pairs, TOL)

    print("\n--- H100 roofline projection for the selected hot loop ---")
    bytes_moved = 8 * cfg.n_banks * (cfg.n_samples * 2 + cfg.n_taps)  # c64 IO
    proj = projected_seconds(cfg.flops, bytes_moved,
                             peak_flops=PEAK_FLOPS_FP32)
    base_s = report.baseline.run_seconds
    print(f"paper speedup (Arria10 FPGA vs Xeon):   {PAPER_SPEEDUP}x")
    print(f"measured on {report.backend}: {report.speedup:.2f}x")
    print(f"projected H100 kernel time: {proj['seconds'] * 1e6:.3f} us "
          f"({proj['bound']}-bound, published peaks at 700 W) vs all-ref "
          f"baseline {base_s * 1e3:.2f} ms on {report.backend}")
    return {"report": report, "max_abs_err": err, "projection": proj}


if __name__ == "__main__":
    main()
