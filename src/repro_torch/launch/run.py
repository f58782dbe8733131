"""Benchmark harness entry point of the port, one section per paper table
or figure (the twin of ``benchmarks/run.py``).

  fig4          paper Fig. 4 (tdFIR / MRI-Q automatic-offload speedups)
  conditions    paper §5.1.2 evaluation-conditions table (loop narrowing)
  extraction    static extractor precision/recall against the annotated
                archs + discover()-driven planning of unannotated programs
  strategies    staged vs genetic vs surrogate vs exhaustive at equal budget
  autotune      tile-parameter autotuning: tuned vs fixed genome at equal d
  verification  serial vs pipelined pattern verification (core/executor.py)
  replanning    online replanning: hot-swap pause, pre/post-swap throughput,
                warm re-open measurement budget (serving/replan.py)
  faults        fault tolerance: retry/quarantine cost under an injected
                fault storm + mid-serve rollback tick pause (core/faults.py)
  kernels       the model regions' variants timed on the device + H100
                roofline projection
  roofline      H100 roofline terms of each cell of a dry-run JSONL
                (``launch/dryrun.py``; given with ``--dryrun``)
  scaling       single- vs multi-pod weak scaling of the same JSONL

Every section of the JAX harness has its twin here.  ``autotune`` and
``verification`` compare the timings of two plans under rule P
(``launch/paired.py``); ``faults`` serves ``--arch`` (reduced, in float32,
with ``--reduced``).  ``roofline`` and ``scaling`` read the JSONL given
with ``--dryrun`` and run on the host only; ``all`` takes them when it
is given.

With ``--json`` every section but fig4 writes ``BENCH_<section>.json``
into ``--out`` (default: the current directory), the documents
``launch/trend.py`` compares.

    PYTHONPATH=src python -m repro_torch.launch.run [--section NAME] \\
        [--json] [--out DIR] [--device cpu --reduced] [--arch NAME]
"""
from __future__ import annotations

import argparse
import importlib
import os

SECTIONS = ("all", "conditions", "extraction", "strategies", "autotune",
            "verification", "replanning", "faults", "fig4", "kernels",
            "roofline", "scaling")
# the sections that read a dry-run JSONL (--dryrun) instead of a device
DRYRUN_SECTIONS = ("roofline", "scaling")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--section", default="all", choices=SECTIONS)
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
    ap.add_argument("--dryrun", default=None,
                    help="roofline/scaling sections: the dry-run JSONL")
    ap.add_argument("--arch", default=None,
                    help="faults section: the served model (default its "
                         "twin's, qwen2-72b)")
    a = ap.parse_args(argv)
    if a.section in DRYRUN_SECTIONS and not a.dryrun:
        ap.error(f"the {a.section} section reads a dry-run JSONL: give it "
                 "with --dryrun (python -m repro_torch.launch.dryrun)")

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
        "autotune": ("kernel autotuning (tuned vs fixed tile genome)",
                     "autotune",
                     ["--budget", str(max(a.budget, 8)), "--reps",
                      str(min(a.reps, 2))] + reduced + doc("autotune")),
        "verification": ("pipelined pattern verification (serial vs "
                         "concurrent compile steps)", "verification",
                         ["--budget", str(max(a.budget, 8)), "--reps",
                          str(a.reps)] + reduced + doc("verification")),
        "replanning": ("online replanning (hot-swap pause + warm re-open)",
                       "replanning", doc("replanning")),
        "faults": ("fault tolerance (fault-storm retries + rollback pause)",
                   "faults", (["--arch", a.arch] if a.arch else [])
                   + reduced + doc("faults")),
        "fig4": ("paper Fig. 4 (automatic offload speedup)", "fig4_offload",
                 ["--reps", str(a.reps)]),
        "kernels": ("kernel bench (name,us_per_call,derived)",
                    "kernel_bench",
                    ["--reps", str(a.reps)] + reduced + doc("kernels")),
        "roofline": ("roofline (H100 data-sheet projection of the dry-run)",
                     "roofline", ["--in", str(a.dryrun)]),
        "scaling": ("weak scaling, 1 pod vs 2 (H100 projection)", "scaling",
                    ["--in", str(a.dryrun)]),
    }
    if a.json:
        os.makedirs(a.out, exist_ok=True)
    results = {}
    for section, (title, module, argv_) in plan.items():
        if a.section not in ("all", section):
            continue
        if section in DRYRUN_SECTIONS:
            if not a.dryrun:            # "all" without a dry-run JSONL
                continue
            extra = []                  # the host reads a file: no device
        else:
            extra = common
        print(f"== {title} ==", flush=True)
        mod = importlib.import_module(f"repro_torch.launch.{module}")
        results[section] = mod.main(argv_ + extra)
        print()
    return results


if __name__ == "__main__":
    main()
