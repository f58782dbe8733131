"""Paper Fig. 4 on the port: automatic offload of tdFIR and MRI-Q.

Two columns per app:
  1. paper     — the paper's measured FPGA-vs-CPU speedup (4.0x / 7.1x,
                 Intel PAC Arria10 GX vs Xeon Bronze 3104).
  2. measured  — the planner's selected pattern vs the all-ref baseline on
                 the device the program runs on (``--device``, default
                 ``cuda``), both timed by the planner's Step 4.

Run:  PYTHONPATH=src python -m repro_torch.launch.fig4_offload \\
          [--app tdfir|mriq|all] [--reps N] [--no-cache] [--device cuda]
"""
from __future__ import annotations

import argparse

from repro_torch.apps import mriq, tdfir
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.planner import AutoOffloader, PlannerConfig
from repro_torch.core.regions import Impl

PAPER = {"tdfir": 4.0, "mriq": 7.1}
APPS = {"tdfir": tdfir.make_program, "mriq": mriq.make_program}


def run_app(name: str, device=None, reps: int = 5,
            cache: PlanCache | None = None) -> dict:
    prog = APPS[name](device=device)
    report = AutoOffloader(PlannerConfig(reps=reps)).plan(prog, cache=cache)
    return {
        "app": name,
        "device": report.backend,
        "paper_speedup": PAPER[name],
        "measured_speedup": report.speedup,
        "baseline_ms": report.baseline.run_seconds * 1e3,
        "best_pattern": report.best_pattern,
        "n_measured": len(report.measurements),
        "report": report,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--app", choices=("tdfir", "mriq", "all"), default="all")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-cache", action="store_true",
                    help="always re-measure instead of using the plan cache")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)
    cache = None if args.no_cache else PlanCache.default()
    names = list(APPS) if args.app == "all" else [args.app]
    print("app,device,paper_speedup,measured_speedup,baseline_ms,"
          "n_measured,best_pattern")
    for name in names:
        r = run_app(name, device=args.device, reps=args.reps, cache=cache)
        best = Impl(r["best_pattern"]).describe() if r["best_pattern"] else "none"
        print(f"{r['app']},{r['device']},{r['paper_speedup']},"
              f"{r['measured_speedup']:.2f},{r['baseline_ms']:.3f},"
              f"{r['n_measured']},{best}")
        print("#", r["report"].summary().replace("\n", "\n# "))


if __name__ == "__main__":
    main()
