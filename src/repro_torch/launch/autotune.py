"""Kernel autotuning on the port: the (variant, tile params) genome against
the variant-only one at equal budget (the twin of
``benchmarks/autotune.py``).

A variant that declared a ``TuningSpace`` contributes every valid tile
point as an allele (``tune_tiles``).  The section checks the JAX
benchmark's claims on the two programs the tuning targets, tdFIR's
``fir_bank=hopper`` (``block_n`` x ``tap_unroll``) and the decode-attention
program's ``decode_attn=hopper`` (``block_k``):

* **tuned no slower than fixed at equal budget** — per app, the same
  strategy planned with ``tune_tiles`` off and on at the same ``d``
  (tdFIR under ``staged``, whose round 4 only climbs to improving tile
  points; the decode program under ``exhaustive``, whose tuned space
  holds the fixed point); the tuned space must be larger than the fixed;
* **surrogate spends fewer real measurements than exhaustive** — both
  tuned on tdFIR at the same ``d``, when exhaustive spends all of it;
* **the winner does not depend on ``verify_workers``** — the tuned decode
  plan at 1 and 2 workers measures the same pattern sequence (hard) and
  selects the same winner;
* **a warm tuned cache entry costs zero budget** — an identical re-plan
  measures nothing, and a re-opened search at d+2 is primed from the
  cache.

Rule P (``launch/paired.py``), for "tuned no slower than fixed x 1.05" and
"the same winner": each plan measures on its own (no plan is handed
another plan's medians); a failing pair of plans is made once more (JAX's
one retry); when it still fails, the two winners A (fixed, or the 1-worker
plan's) and B (tuned, or the 2-worker plan's) are built once from one
program instance on one input, warmed with one call each, and timed in 5
rounds of A, B, B, A (CUDA events after a synchronize on a card, the host
clock on the CPU).  On the CPU the timed claims are reported, not
asserted.  With r the median of (B1 + B2) / (A1 + A2), "no
slower" passes at r <= 1.05 and "same winner" at r within [1/1.05, 1.05].
Rows record ``decided_by`` (``plan``, ``retry`` or ``paired``) and, when
it ran, ``paired_ratio``.  The sequences, counts and spaces are never
re-timed.

``--reduced`` plans tdFIR at 4 x 16 taps x 256 samples (for the CPU, as
``launch/strategies.py``); the decode program keeps the JAX package's
[2, 8/2, 512, 64] float32.  With ``--json PATH`` the rows land in a
``BENCH_autotune.json`` document (rows keyed on ``app`` + ``mode``).

Run:  PYTHONPATH=src python -m repro_torch.launch.autotune \\
          [--budget 8] [--device cuda] [--reduced] [--json PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch.apps import tdfir
from repro_torch.apps.decode_attn import make_decode_program
from repro_torch.configs.paper_apps import TDFIR_FULL, TdFirConfig
from repro_torch.core.device import backend_name, resolve_device
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.planner import AutoOffloader, PlannerConfig
from repro_torch.core.regions import Impl, split_gene
from repro_torch.core.search import impl_key
from repro_torch.launch import paired

# --reduced: tdFIR at the strategies twin's CPU size
REDUCED_TDFIR = TdFirConfig(4, 16, 256)
# (app, strategy of the fixed-vs-tuned comparison)
APPS = (("tdfir", "staged"), ("decode_attn", "exhaustive"))


def programs(device, reduced: bool = False) -> dict:
    """app -> a factory of its program on ``device``."""
    fir_cfg = REDUCED_TDFIR if reduced else TDFIR_FULL
    return {"tdfir": lambda: tdfir.make_program(fir_cfg, device=device),
            "decode_attn": lambda: make_decode_program(device)}


def _n_tile_patterns(rep) -> int:
    """Measured patterns carrying at least one non-default tile gene."""
    return sum(any(split_gene(v)[1] for v in m.mapping().values())
               for m in list(rep.measurements) + list(rep.reused))


def plan_once(make, *, tune: bool, strategy: str, budget: int, reps: int,
              seed: int = 0, workers: int = 1, cache=None):
    cfg = PlannerConfig(max_measurements=budget, reps=reps, strategy=strategy,
                        seed=seed, verify_workers=workers, tune_tiles=tune)
    return AutoOffloader(cfg).plan(make(), cache=cache)


def row_from(app: str, mode: str, rep, budget: int) -> dict:
    return {
        "app": app,
        "mode": mode,              # fixed | tuned | tuned-surrogate | ...
        "strategy": rep.strategy,
        "budget": budget,
        "n_measured": len(rep.measurements),
        "n_tile_patterns": _n_tile_patterns(rep),
        "search_space": rep.search_space,
        "baseline_ms": rep.baseline.run_seconds * 1e3,
        "best_ms": rep.best_seconds * 1e3,
        "speedup": rep.speedup,
        "best_pattern": Impl(rep.best_pattern).describe(),
        "decided_by": "plan",
    }


def run(progs: dict, budget: int = 8, reps: int = 2,
        seed: int = 0) -> list[dict]:
    rows = []
    for app, strat in APPS:
        make = progs[app]
        # fixed and tuned are separate timed plans; rule P decides a tuned
        # winner measured slower than the fixed one
        for attempt in ("plan", "retry"):
            fixed = plan_once(make, tune=False, strategy=strat, budget=budget,
                              reps=reps, seed=seed)
            tuned = plan_once(make, tune=True, strategy=strat, budget=budget,
                              reps=reps, seed=seed)
            if tuned.best_seconds <= fixed.best_seconds * paired.TIE:
                break
            if attempt == "plan":
                print(f"# {app}: tuned winner measured slower than fixed: "
                      "retrying once")
        f_row = row_from(app, "fixed", fixed, budget)
        t_row = row_from(app, "tuned", tuned, budget)
        f_row["decided_by"] = t_row["decided_by"] = attempt
        if tuned.best_seconds > fixed.best_seconds * paired.TIE:
            ratio = paired.retime(make(), fixed.best_pattern,
                                  tuned.best_pattern)
            for r in (f_row, t_row):
                r["decided_by"], r["paired_ratio"] = "paired", ratio
        rows += [f_row, t_row]
    # surrogate against exhaustive tile search, both tuned, same budget, on
    # tdFIR, whose tuned space dwarfs the budget
    for mode, strat in (("tuned-surrogate", "surrogate"),
                        ("tuned-exhaustive", "exhaustive")):
        rep = plan_once(progs["tdfir"], tune=True, strategy=strat,
                        budget=budget, reps=reps, seed=seed)
        rows.append(row_from("tdfir", mode, rep, budget))
    return rows


def workers_determinism(make, budget: int, reps: int) -> dict:
    """The tuned decode plan at verify_workers 1 and 2: the same measured
    sequence (hard: exhaustive proposals never depend on timings) and the
    same winner (rule P)."""
    for attempt in ("plan", "retry"):
        reports = [plan_once(make, tune=True, strategy="exhaustive",
                             budget=budget, reps=reps, workers=w)
                   for w in (1, 2)]
        seqs = [[m.pattern for m in r.measurements] for r in reports]
        assert seqs[0] == seqs[1], (
            f"tuned measured sequence diverged across verify_workers:\n"
            f"  w=1 {seqs[0]}\n  w=2 {seqs[1]}")
        keys = [impl_key(Impl(r.best_pattern)) for r in reports]
        if keys[0] == keys[1]:
            break
        if attempt == "plan":
            print("# tuned winner differs across verify_workers: retrying "
                  "once")
    out = {"patterns": seqs[0],
           "winner": Impl(reports[0].best_pattern).describe(),
           "winner_w2": Impl(reports[1].best_pattern).describe(),
           "decided_by": attempt}
    if keys[0] != keys[1]:
        out["decided_by"] = "paired"
        out["paired_ratio"] = paired.retime(make(), reports[0].best_pattern,
                                            reports[1].best_pattern)
    return out


def warm_cache_demo(make, budget: int, reps: int) -> dict:
    """An identical tuned re-plan is a zero-measurement cache hit, and a
    re-opened tuned search (changed budget) is primed with the persisted
    tile-point measurements."""
    with tempfile.TemporaryDirectory() as d:
        cache = PlanCache(os.path.join(d, "plans.json"))
        kw = dict(tune=True, strategy="exhaustive", reps=reps, cache=cache)
        cold = plan_once(make, budget=budget, **kw)
        hot = plan_once(make, budget=budget, **kw)
        reopened = plan_once(make, budget=budget + 2, **kw)
        return {
            "cold_measured": len(cold.measurements),
            "cold_tile_patterns": _n_tile_patterns(cold),
            "hot_from_cache": hot.from_cache,
            "hot_measured": len(hot.measurements),
            "reopened_measured": len(reopened.measurements),
            "reopened_reused": len(reopened.reused),
        }


def check(rows: list[dict], det: dict, demo: dict, budget: int,
          timed: bool = True) -> None:
    """The JAX benchmark's hard assertions, the timed ones (by rule P)
    only when ``timed``."""
    by = {(r["app"], r["mode"]): r for r in rows}
    for app, _ in APPS:
        fixed, tuned = by[(app, "fixed")], by[(app, "tuned")]
        assert tuned["search_space"] > fixed["search_space"], (
            f"{app}: tune_tiles did not widen the search space "
            f"({tuned['search_space']} vs {fixed['search_space']})")
        if not timed:
            continue
        if tuned["decided_by"] == "paired":
            assert paired.no_slower(tuned["paired_ratio"]), (
                f"{app}: tuned winner {tuned['best_pattern']} slower than "
                f"the fixed winner {fixed['best_pattern']}: paired ratio "
                f"{tuned['paired_ratio']:.4f} > {paired.TIE}")
        else:
            assert tuned["best_ms"] <= fixed["best_ms"] * paired.TIE
    surr = by[("tdfir", "tuned-surrogate")]
    exh = by[("tdfir", "tuned-exhaustive")]
    if exh["n_measured"] >= budget:
        assert surr["n_measured"] < exh["n_measured"], (
            f"surrogate tuning spent {surr['n_measured']} real measurements,"
            f" exhaustive {exh['n_measured']}: the surrogate must spend "
            f"strictly fewer at equal budget")
    if timed and det["decided_by"] == "paired":
        assert paired.ties(det["paired_ratio"]), (
            f"tuned winner diverged across verify_workers: {det['winner']} "
            f"vs {det['winner_w2']}, paired ratio {det['paired_ratio']:.4f}")
    assert demo["hot_from_cache"] and demo["hot_measured"] == 0, \
        "identical tuned re-plan must be a zero-measurement cache hit"


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--budget", type=int, default=8,
                    help="d, shared by the fixed and tuned plans")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--reduced", action="store_true",
                    help="plan tdFIR at a small size (for the CPU)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write a BENCH_autotune.json document here")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    progs = programs(dev, a.reduced)
    rows = run(progs, budget=a.budget, reps=a.reps, seed=a.seed)
    det = workers_determinism(progs["decode_attn"], a.budget, a.reps)
    demo = warm_cache_demo(progs["decode_attn"], a.budget,
                           max(1, a.reps - 1))

    print("app,mode,strategy,budget,measured,tile_patterns,space,"
          "baseline_ms,best_ms,speedup,pattern,decided_by")
    for r in rows:
        print(f"{r['app']},{r['mode']},{r['strategy']},{r['budget']},"
              f"{r['n_measured']},{r['n_tile_patterns']},{r['search_space']},"
              f"{r['baseline_ms']:.3f},{r['best_ms']:.3f},{r['speedup']:.2f},"
              f"{r['best_pattern']},{r['decided_by']}"
              + (f" (paired ratio {r['paired_ratio']:.4f})"
                 if "paired_ratio" in r else ""))
    by = {(r["app"], r["mode"]): r for r in rows}
    for app, strat in APPS:
        fixed, tuned = by[(app, "fixed")], by[(app, "tuned")]
        print(f"# {app} [{strat}]: tuned best {tuned['best_ms']:.3f} ms, "
              f"fixed best {fixed['best_ms']:.3f} ms at d={a.budget} (tuned "
              f"space {tuned['search_space']} vs {fixed['search_space']}; "
              f"{tuned['n_tile_patterns']} tile patterns measured; decided "
              f"by {tuned['decided_by']})")
    surr = by[("tdfir", "tuned-surrogate")]
    exh = by[("tdfir", "tuned-exhaustive")]
    print(f"# tdfir tuned: surrogate spent {surr['n_measured']} real "
          f"measurements vs exhaustive {exh['n_measured']} at d={a.budget} "
          f"(space {exh['search_space']})")
    print(f"# decode_attn tuned winner at verify_workers 1 and 2: "
          f"{det['winner']} / {det['winner_w2']} over "
          f"{len(det['patterns'])} measured patterns (decided by "
          f"{det['decided_by']})")
    print(f"# tuned warm cache: cold measured {demo['cold_measured']} "
          f"({demo['cold_tile_patterns']} tile patterns); identical re-plan "
          f"from_cache={demo['hot_from_cache']} measured "
          f"{demo['hot_measured']}; re-opened (d+2) measured "
          f"{demo['reopened_measured']} reused {demo['reopened_reused']}")
    # the host clock of a shared CPU decides no timing claim
    check(rows, det, demo, a.budget, timed=dev.type == "cuda")
    if a.json:
        doc = {"section": "autotune", "backend": backend_name(dev),
               "budget": a.budget, "workers_determinism": det,
               "warm_cache": demo, "rows": rows}
        with open(a.json, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        print(f"# wrote {a.json}")
    return rows


if __name__ == "__main__":
    main()
