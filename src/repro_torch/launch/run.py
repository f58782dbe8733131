"""Benchmark harness entry point of the port, one section per paper table
or figure (the twin of ``benchmarks/run.py``).

  fig4          paper Fig. 4 (tdFIR / MRI-Q automatic-offload speedups)
  conditions    paper §5.1.2 evaluation-conditions table (loop narrowing)
  extraction    static extractor precision/recall against the annotated
                archs + discover()-driven planning of unannotated programs
  strategies    staged vs genetic vs surrogate vs exhaustive at equal budget
  replanning    online replanning: hot-swap pause, pre/post-swap throughput,
                warm re-open measurement budget (serving/replan.py)
  kernels       the model regions' variants timed on the device + H100
                roofline projection

The JAX harness's ``autotune``, ``verification`` and ``faults`` sections
come with the next slice of the port, and ``roofline`` and ``scaling``
(which read the multi-device dry-run's JSONL) with the multi-device
slice: asking for one of them exits non-zero and says so.

With ``--json`` every section but fig4 writes ``BENCH_<section>.json``
into ``--out`` (default: the current directory), the documents
``launch/trend.py`` compares.

    PYTHONPATH=src python -m repro_torch.launch.run [--section NAME] \\
        [--json] [--out DIR] [--device cpu --reduced]
"""
from __future__ import annotations

import argparse
import importlib
import os

SECTIONS = ("all", "conditions", "extraction", "strategies", "replanning",
            "fig4", "kernels")
# the JAX harness's sections that the port does not have yet
LATER = {"autotune": "the next slice of the port",
         "verification": "the next slice of the port",
         "faults": "the next slice of the port",
         "roofline": "the multi-device slice of the port",
         "scaling": "the multi-device slice of the port"}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--section", default="all", choices=SECTIONS + tuple(LATER))
    ap.add_argument("--json", action="store_true",
                    help="write BENCH_<section>.json into --out for the "
                         "sections that support it")
    ap.add_argument("--out", default=".", help="directory of the documents")
    ap.add_argument("--budget", type=int, default=4,
                    help="strategies section: measurement budget d")
    ap.add_argument("--reps", type=int, default=3,
                    help="timing reps per pattern")
    ap.add_argument("--reduced", action="store_true",
                    help="small apps and models (for the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    a = ap.parse_args(argv)
    if a.section in LATER:
        ap.exit(2, f"run: the {a.section} section comes with "
                   f"{LATER[a.section]}\n")

    common = (["--device", a.device] if a.device else [])
    reduced = ["--reduced"] if a.reduced else []

    def doc(section: str) -> list[str]:
        if not a.json:
            return []
        return ["--json", os.path.join(a.out, f"BENCH_{section}.json")]

    # section -> (title, launcher module, its argv); imported on use
    plan = {
        "conditions": ("paper §5.1.2 conditions (loop extraction & "
                       "narrowing)", "loop_extraction",
                       ["--conditions", "--reps", str(a.reps)] + reduced
                       + doc("conditions")),
        "extraction": ("static extraction (recognizer accuracy + "
                       "unannotated auto-plan)", "loop_extraction",
                       ["--reps", "1"] + reduced + doc("extraction")),
        "strategies": ("search strategies (staged vs genetic vs surrogate "
                       "vs exhaustive)", "strategies",
                       ["--budget", str(a.budget), "--reps", str(a.reps)]
                       + reduced + doc("strategies")),
        "replanning": ("online replanning (hot-swap pause + warm re-open)",
                       "replanning", doc("replanning")),
        "fig4": ("paper Fig. 4 (automatic offload speedup)", "fig4_offload",
                 ["--reps", str(a.reps)]),
        "kernels": ("kernel bench (name,us_per_call,derived)",
                    "kernel_bench",
                    ["--reps", str(a.reps)] + reduced + doc("kernels")),
    }
    if a.json:
        os.makedirs(a.out, exist_ok=True)
    results = {}
    for section, (title, module, argv_) in plan.items():
        if a.section not in ("all", section):
            continue
        print(f"== {title} ==", flush=True)
        mod = importlib.import_module(f"repro_torch.launch.{module}")
        results[section] = mod.main(argv_ + common)
        print()
    return results


if __name__ == "__main__":
    main()
