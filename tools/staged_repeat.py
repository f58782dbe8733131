#!/usr/bin/env python3
"""How often the staged search picks a worse winner on tdFIR, on one
NVIDIA card.

    PYTHONPATH=src python3 tools/staged_repeat.py

Makes 8 staged plans of tdFIR (HPEC set 1) at d=8 and 2 timed reps a
pattern, fixed and then tuned, as the autotune twin makes them
(``launch/autotune.py``: ``plan_once``), each on no plan cache, and prints
every rep of every measured pattern with how it was timed.  Then every
distinct winner is timed once more on the same footing (one
``search.time_callable`` of 50 reps each, in turn) and a plan counts as
picking a worse winner when its winner's median lies more than 5% (rule
P's bound) above the fastest winner's of its mode.  Needs a card; exits 2
without one.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import search  # noqa: E402
from repro_torch.core.regions import Impl  # noqa: E402
from repro_torch.launch import autotune, paired  # noqa: E402

PLANS, REPS, BUDGET = 8, 2, 8      # the autotune twin's reps and d


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card (torch.cuda.is_available() is False)")
        return 2
    dev = torch.device("cuda")
    make = autotune.programs(dev)["tdfir"]
    for tune in (False, True):
        mode = "tuned" if tune else "fixed"
        winners, mappings = [], {}
        for i in range(PLANS):
            rep = autotune.plan_once(make, tune=tune, strategy="staged",
                                     budget=BUDGET, reps=REPS)
            b = rep.baseline
            print(f"{mode} plan {i}: baseline {b.run_seconds * 1e3:.4f} ms "
                  f"{[round(r * 1e3, 4) for r in b.runs]} ({b.timed_as})")
            for m in rep.measurements:
                print(f"  {m.pattern}: {m.run_seconds * 1e3:.4f} ms "
                      f"{[round(r * 1e3, 4) for r in m.runs]} ({m.timed_as})"
                      + ("" if m.ok else f" FAILED {m.error}"))
            winner = Impl(rep.best_pattern).describe()
            print(f"  winner {winner} {rep.best_seconds * 1e3:.4f} ms")
            winners.append(winner)
            mappings[winner] = dict(rep.best_pattern)
        prog = make()
        sample = prog.sample_inputs(0, prog.device)
        medians = {}
        for w, impl in sorted(mappings.items()):
            m = search.time_callable(prog.build(Impl(impl)), sample,
                                     warmup=2, reps=50)
            medians[w] = m.run_seconds
        best = min(medians.values())
        worse = sum(medians[w] > paired.TIE * best for w in winners)
        print(f"# {mode}: winners " + ", ".join(
            f"{w} x{winners.count(w)} ({medians[w] * 1e3:.4f} ms)"
            for w in sorted(medians)))
        print(f"# {mode}: {worse} of {PLANS} plans picked a winner more "
              f"than {paired.TIE:.2f}x the fastest winner "
              f"({best * 1e3:.4f} ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
