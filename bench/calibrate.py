"""Readings for a cell's correctness limit: the widest gap of the program's
served tokens on many seeds, and of the control's (the reference one
precision step below the served bf16, put in the program's place) on
some of them.

    python3 bench/calibrate.py --workload nemo12b.chat --seconds 51 \\
        --seeds 1 2 3 ... --control 4

Each seed is one whole run of the cell (``harness.run_cell``: set-up,
the window, the comparison), in one process; the first ``--control``
seeds are run with the control judged in the program's place, and they
give the program's reading too.  One JSON line a seed, with ``correct``
as the cell's limits file decides it.  A tool for setting the limit in
``bench/limits/``, not part of a run.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0)
    args = ap.parse_args()
    harness.cache_dirs(ROOT)
    import torch

    from bench.spec import Spec

    spec = Spec(ROOT)
    dev = torch.device("cuda:0")
    print(f"calibrate {args.workload} on {torch.cuda.get_device_name(dev)}",
          flush=True)
    for i, seed in enumerate(args.seeds):
        control = i < args.control
        out = harness.run_cell(spec, args.workload, seed, args.seconds, False,
                               dev, control=control)
        row = {"seed": seed, "control": control, "correct": out["correct"],
               **out["readings"],
               "checks": {k: c["value"] for k, c in out["checks"].items()},
               "metrics": {k: v["value"] for k, v in out["metrics"].items()},
               "memory_peak_bytes": out["device"]["memory_peak_bytes"]}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
