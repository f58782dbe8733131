"""Find the knee of an open-loop cell: the highest arrival rate at which
the backlog does not grow through a window.

    python3 bench/sweep.py --workload nemo12b.chat --seed <n> --seconds 40 \\
        --rates 2.0 2.5 3.0 3.5 4.0

Each rate is one whole run of the cell (``harness.run_cell``) with that
rate in place of its mix file's, in one process.  For each rate it
prints the offered and completed requests, the backlog (requests waiting
for a slot) over the window's quarters, the tails and ``correct``; the
knee is the last rate whose backlog stays flat.  A tool run once when a
cell is defined, not part of a run.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402


def backlog(spec, win) -> dict:
    """The backlog over the window's quarters, its completed requests, the
    decode tick and the slots' occupancy."""
    import numpy as np
    ticks = win.window_ticks()
    run = harness.RunView(win, None, {}, {}, None, 0.0)
    q = np.array_split(np.array([k.queue for k in ticks]), 4)
    done = sum(1 for s in win.measured() if s.req.done
               and s.req.finish_s < win.t_close)
    return {"offered": len(win.measured()), "completed": done,
            "backlog_by_quarter": [float(x.mean()) if x.size else 0.0
                                   for x in q],
            "backlog_end": ticks[-1].queue if ticks else 0,
            "decode_tick_ms": spec.reader("decode_tick_ms").read(run),
            "slot_occupancy": spec.reader("slot_occupancy").read(run)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args()
    harness.cache_dirs(ROOT)
    import torch

    from bench.spec import Spec

    spec = Spec(ROOT)
    dev = torch.device("cuda:0")
    print(f"sweep {args.workload} on {torch.cuda.get_device_name(dev)}; "
          f"{args.seconds} s a rate", flush=True)
    for r in args.rates:
        seen = {}

        def look(win):
            seen.update(backlog(spec, win))
        out = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                               False, dev, rate=r, on_window=look)
        row = {"rate_rps": r, **seen, "correct": out["correct"],
               **{k: v["value"] for k, v in out["metrics"].items()}}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
