#!/usr/bin/env python3
"""Why the autotune twin's tuned decode plans can pick different winners
at verify_workers 1 and 2, on one NVIDIA card.

    PYTHONPATH=src python3 tools/decode_tune_repeat.py

Makes the tuned decode-attention plan (``launch/autotune.py``:
``plan_once``, exhaustive, d=8, 2 timed reps a pattern) 6 times at each of
verify_workers 1 and 2, in turns, on no plan cache, and prints every rep of
every measured pattern with its first call and compile seconds.  Then it
times each pattern's graph once more in turns, 40 replays each, two ways:
"ungated", CUDA events around one replay on a drained stream, so that the
host's launch of the graph falls inside the interval (how Step 4 timed a
rep before ``search.TIMING_GATE_CYCLES``), and "gated", the start event
queued behind that device-side wait (``torch.cuda._sleep``), so that the
graph is already queued when the start event runs and the interval holds
the device's work alone (how Step 4 times a rep now).  Needs a card;
exits 2 without one.
"""
from __future__ import annotations

import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import search  # noqa: E402
from repro_torch.core.regions import Impl  # noqa: E402
from repro_torch.launch import autotune  # noqa: E402

PLANS, REPS, BUDGET = 6, 2, 8      # the autotune twin's reps and d
REPLAYS = 40


def ms(xs) -> list[float]:
    return [round(x * 1e3, 4) for x in xs]


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card (torch.cuda.is_available() is False)")
        return 2
    dev = torch.device("cuda")
    make = autotune.programs(dev)["decode_attn"]
    patterns = {}
    for i in range(PLANS):
        for workers in (1, 2):
            rep = autotune.plan_once(make, tune=True, strategy="exhaustive",
                                     budget=BUDGET, reps=REPS,
                                     workers=workers)
            b = rep.baseline
            print(f"plan {i} verify_workers {workers}: baseline "
                  f"{b.run_seconds * 1e3:.4f} ms {ms(b.runs)}")
            for m in rep.measurements:
                print(f"  {m.pattern}: {m.run_seconds * 1e3:.4f} ms "
                      f"{ms(m.runs)}, first call "
                      f"{m.first_run_seconds * 1e3:.3f} ms, compile "
                      f"{m.compile_seconds * 1e3:.1f} ms ({m.timed_as})")
                patterns[m.pattern] = dict(m.mapping())
            print(f"  winner {Impl(rep.best_pattern).describe()}")
    prog = make()
    args = prog.sample_inputs(0, prog.device)
    graphs = {}
    for name, impl in sorted(patterns.items()):
        fn = prog.build(Impl(impl))
        fn(*args)
        graphs[name] = search.capture_pattern(fn, args)
    stream = torch.cuda.current_stream()
    times = {(n, how): [] for n in graphs for how in ("ungated", "gated")}
    for _ in range(REPLAYS):
        for name, graph in graphs.items():
            for how in ("ungated", "gated"):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                stream.synchronize()
                if how == "gated":
                    torch.cuda._sleep(search.TIMING_GATE_CYCLES)
                start.record(stream)
                graph.replay()
                end.record(stream)
                end.synchronize()
                times[(name, how)].append(start.elapsed_time(end))
    for (name, how), xs in sorted(times.items()):
        print(f"{name} {how}: median {statistics.median(xs):.4f} ms, "
              f"[{min(xs):.4f}-{max(xs):.4f}] over {len(xs)} replays")
    for graph in graphs.values():
        graph.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
