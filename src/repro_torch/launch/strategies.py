"""Search-strategy shoot-out on the port: staged vs genetic vs surrogate vs
exhaustive at equal budget (the twin of ``benchmarks/strategies.py``).

Every strategy plans tdFIR and MRI-Q under the SAME budget ``d``; per
(app, strategy) the table reports the patterns measured (budget actually
consumed), the patterns reused from the plan cache, whether any pattern was
measured twice (must never happen — the MeasurementLedger dedups), the
selected pattern, its measured median and the compile seconds spent.

Two claims are checked on every run, as in the JAX benchmark:

* ``surrogate`` consumes strictly fewer real measurements than plain
  ``genetic`` at the same ``d`` (at ``d >= 2``);
* an identical re-plan against a warm plan cache consumes ZERO new
  measurements, and a re-opened search (changed budget) is primed from the
  cache's persisted measurements.

``--reduced`` plans the apps at small sizes (tdFIR 4 x 16 taps x 256
samples, MRI-Q 300 x 200) — for the CPU; the default is the paper sizes.

Run:  PYTHONPATH=src python -m repro_torch.launch.strategies \\
          [--budget 4] [--reps 3] [--device cuda] [--reduced] [--json PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch.apps import mriq, tdfir
from repro_torch.configs.paper_apps import MriQConfig, TdFirConfig
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.planner import AutoOffloader, PlannerConfig
from repro_torch.core.search import impl_key

STRATEGIES = ("staged", "genetic", "surrogate", "exhaustive")


def programs(device=None, reduced: bool = False) -> dict:
    """app -> a factory of its program on ``device``."""
    if reduced:
        fir_cfg, q_cfg = TdFirConfig(4, 16, 256), MriQConfig(300, 200)
        return {"tdfir": lambda: tdfir.make_program(fir_cfg, device=device),
                "mriq": lambda: mriq.make_program(q_cfg, device=device)}
    return {"tdfir": lambda: tdfir.make_program(device=device),
            "mriq": lambda: mriq.make_program(device=device)}


def run(budget: int = 4, reps: int = 3, seed: int = 0, device=None,
        reduced: bool = False) -> list[dict]:
    rows = []
    for app, make in programs(device, reduced).items():
        for strat in STRATEGIES:
            cfg = PlannerConfig(max_measurements=budget, reps=reps,
                                strategy=strat, seed=seed)
            rep = AutoOffloader(cfg).plan(make())
            keys = [impl_key(m.impl) for m in rep.measurements]
            rows.append({
                "app": app,
                "strategy": rep.strategy,
                "budget": budget,
                "n_measured": len(rep.measurements),
                "n_reused": len(rep.reused),
                "unique_patterns": len(set(keys)) == len(keys),
                "baseline_ms": rep.baseline.run_seconds * 1e3,
                "best_ms": rep.best_seconds * 1e3,
                "speedup": rep.speedup,
                "best_pattern": dict(rep.best_pattern),
                "compile_ms_total": sum(m.compile_seconds
                                        for m in rep.measurements) * 1e3,
            })
    return rows


def warm_cache_demo(budget: int = 4, reps: int = 2, seed: int = 0,
                    device=None, reduced: bool = False) -> dict:
    """Cross-run measurement reuse on tdFIR: identical re-plan = cache hit
    (zero measurements); changed-budget re-plan = primed ledger."""
    make = programs(device, reduced)["tdfir"]
    with tempfile.TemporaryDirectory() as d:
        cache = PlanCache(os.path.join(d, "plans.json"))
        cfg = PlannerConfig(max_measurements=budget, reps=reps,
                            strategy="surrogate", seed=seed)
        cold = AutoOffloader(cfg).plan(make(), cache=cache)
        hot = AutoOffloader(cfg).plan(make(), cache=cache)
        reopened = AutoOffloader(
            PlannerConfig(max_measurements=budget + 2, reps=reps,
                          strategy="surrogate", seed=seed)).plan(
            make(), cache=cache)
        return {
            "cold_measured": len(cold.measurements),
            "hot_from_cache": hot.from_cache,
            "hot_measured": len(hot.measurements),
            "reopened_measured": len(reopened.measurements),
            "reopened_reused": len(reopened.reused),
        }


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--budget", type=int, default=4, help="d, per strategy")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--reduced", action="store_true",
                    help="plan the apps at small sizes (for the CPU)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the rows as JSON here")
    a = ap.parse_args(argv)
    rows = run(budget=a.budget, reps=a.reps, seed=a.seed, device=a.device,
               reduced=a.reduced)
    print("app,strategy,budget,measured,reused,unique,baseline_ms,best_ms,"
          "speedup,pattern")
    for r in rows:
        pat = "+".join(f"{k}={v}" for k, v in sorted(r["best_pattern"].items())
                       ) or "all-ref"
        print(f"{r['app']},{r['strategy']},{r['budget']},{r['n_measured']},"
              f"{r['n_reused']},{r['unique_patterns']},{r['baseline_ms']:.3f},"
              f"{r['best_ms']:.3f},{r['speedup']:.2f},{pat}")
        assert r["unique_patterns"], \
            f"{r['app']}/{r['strategy']}: a pattern was measured twice"
    by = {(r["app"], r["strategy"]): r for r in rows}
    for app in programs(a.device, a.reduced):
        ga, staged = by[(app, "genetic")], by[(app, "staged")]
        surr = by[(app, "surrogate")]
        verdict = "<=" if ga["best_ms"] <= staged["best_ms"] * 1.05 else ">"
        print(f"# {app}: genetic best {ga['best_ms']:.3f} ms {verdict} "
              f"staged best {staged['best_ms']:.3f} ms at d={staged['budget']}")
        verdict = ("<=" if surr["best_ms"] <= staged["best_ms"] * 1.05
                   else ">")
        print(f"# {app}: surrogate best {surr['best_ms']:.3f} ms {verdict} "
              f"staged best {staged['best_ms']:.3f} ms with "
              f"{surr['n_measured']} vs genetic {ga['n_measured']} real "
              f"measurements")
        if a.budget >= 2:                # at d=1 both floors at one
            assert surr["n_measured"] < ga["n_measured"], (
                f"{app}: surrogate consumed {surr['n_measured']} real "
                f"measurements, plain genetic {ga['n_measured']} — the "
                f"surrogate must consume strictly fewer at equal budget")
    demo = warm_cache_demo(budget=a.budget, reps=min(a.reps, 2), seed=a.seed,
                           device=a.device, reduced=a.reduced)
    print(f"# warm cache: cold plan measured {demo['cold_measured']}; "
          f"identical re-plan from_cache={demo['hot_from_cache']} measured "
          f"{demo['hot_measured']}; re-opened (d+2) measured "
          f"{demo['reopened_measured']} reused {demo['reopened_reused']}")
    assert demo["hot_from_cache"] and demo["hot_measured"] == 0, \
        "identical re-plan must be a zero-measurement cache hit"
    if a.json:
        with open(a.json, "w") as f:
            json.dump({"section": "strategies", "budget": a.budget,
                       "warm_cache": demo, "rows": rows}, f, indent=2,
                      sort_keys=True)
        print(f"# wrote {a.json}")
    return rows


if __name__ == "__main__":
    main()
