"""Perf-trajectory trend view over the port's ``BENCH_*.json`` documents
(the port's own copy of ``benchmarks/trend.py``; the port imports nothing
of ``benchmarks/``).

``python -m repro_torch.launch.run --json`` writes one document per
section it runs: conditions, extraction, strategies, autotune,
verification, replanning, faults and kernels (fig4 prints its table
only).  This tool compares the current documents against a rolling
window of previous runs and prints per-section, per-row deltas:

    PYTHONPATH=src python -m repro_torch.launch.trend --baseline prev/ \
        [--current .]

``--baseline`` may be a single artifact directory (or file), one
snapshot, or a directory of per-run subdirectories (the last ``--window``
runs, each in ``<baseline>/<run-id>/``); documents are found recursively
inside each snapshot, so nested artifact folders need no flattening.

Rows are matched by their identity columns (``SECTION_KEYS``: ``app`` for
conditions and extraction, ``app`` + ``strategy`` for strategies, ``app``
+ ``workers`` + ``cached_replan`` for verification, ``app`` + ``mode`` for
autotune, replanning and faults, ``name`` for kernels).  Gated metrics compare
against the **median across the window**, so a single noisy sample can
neither fail nor mask the gate:

* ``best_ms``  (lower is better) — the selected pattern's measured median,
* ``speedup``  (higher is better) — against the same run's own baseline.

A gated metric that regresses by more than ``--threshold`` (default 20%)
against the window median fails the run with a non-zero exit.  Everything
else (baseline_ms, n_measured, compile and verify walls, genome sizes,
accuracy counts, swap pauses, fault counts, rollback pauses, kernel
times) is printed for the record but never gates.  With no baseline
documents the tool prints a notice and exits 0: the first run of a new
section has nothing to compare.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from statistics import median

SECTION_KEYS = {
    "strategies": ("app", "strategy"),
    "conditions": ("app",),
    "verification": ("app", "workers", "cached_replan"),
    "extraction": ("app",),
    "autotune": ("app", "mode"),
    "replanning": ("app", "mode"),
    "faults": ("app", "mode"),
    "kernels": ("name",),
}
# metric -> direction: +1 higher is better, -1 lower is better, 0 report-only
METRICS = {
    "best_ms": -1,
    "speedup": +1,
    "baseline_ms": 0,
    "n_measured": 0,
    "n_reused": 0,
    "measured": 0,
    "compile_ms_total": 0,
    "verify_wall_s": 0,
    "compile_wall_s": 0,
    # autotune section: genome-space accounting, recorded but never gating
    "n_tile_patterns": 0,
    "search_space": 0,
    # extraction section: accuracy counts and plan_speedup are recorded for
    # the trajectory but never gate (CPU-runner plan timings are too noisy)
    "tp": 0,
    "fp": 0,
    "fn": 0,
    "regions": 0,
    "plan_speedup": 0,
    # replanning section: swap-pause and warm-reopen accounting, recorded
    # for the trajectory but never gating (tick timings on shared CPU
    # runners are too noisy; the hard gates live in the benchmark itself)
    "swap_tick_ms": 0,
    "median_tick_ms": 0,
    "pre_swap_tok_s": 0,
    "post_swap_tok_s": 0,
    "swaps": 0,
    "n_measured_warm": 0,
    "n_reused_warm": 0,
    "plan_ms_warm": 0,
    # faults section: fault-injection accounting and rollback pause,
    # recorded for the trajectory but never gating (retry counts depend on
    # the injected storm, tick timings on the host are noisy; the hard
    # gates live in the benchmark itself)
    "n_faults_injected": 0,
    "n_retries": 0,
    "n_quarantined": 0,
    "plan_ms_storm": 0,
    "storm_overhead_x": 0,
    "rollbacks": 0,
    "rollback_tick_ms": 0,
    # kernels section: per-variant times and launch counts, recorded but
    # never gating
    "us_per_call": 0,
    "launches": 0,
}
DEFAULT_WINDOW = 5


def load_docs(path: str, recursive: bool = False) -> dict[str, dict]:
    """``BENCH_*.json`` documents in a directory (or a single file), keyed
    by section.  ``recursive`` descends into subdirectories — used for
    baseline snapshots, where each artifact may sit in a folder of its own
    (NOT for ``--current``, which would otherwise swallow the baseline
    directory itself)."""
    if os.path.isfile(path):
        files = [path]
    elif recursive:
        files = sorted(glob.glob(os.path.join(path, "**", "BENCH_*.json"),
                                 recursive=True))
    else:
        files = sorted(glob.glob(os.path.join(path, "BENCH_*.json")))
    docs = {}
    for f in files:
        try:
            with open(f) as fh:
                doc = json.load(fh)
        except (json.JSONDecodeError, OSError) as e:
            print(f"# skipping unreadable {f}: {e}")
            continue
        section = doc.get("section") or os.path.basename(f)[6:-5]
        docs[section] = doc
    return docs


def _snapshot_order(name: str) -> tuple:
    """Sort run-directory names numerically when they are run ids, else
    lexically — newest last either way."""
    return (0, int(name), "") if name.isdigit() else (1, 0, name)


def load_history(path: str, window: int = DEFAULT_WINDOW) -> list[dict]:
    """The baseline as a list of snapshots (oldest first, at most
    ``window``).  A file or a directory with artifacts directly inside is
    ONE snapshot (the single-baseline layout); a directory of per-run
    subdirectories is one snapshot per run."""
    if os.path.isfile(path):
        return [load_docs(path)]
    subdirs = sorted(
        (d for d in os.listdir(path)
         if os.path.isdir(os.path.join(path, d))
         and glob.glob(os.path.join(path, d, "**", "BENCH_*.json"),
                       recursive=True)),
        key=_snapshot_order)
    snapshots = [load_docs(os.path.join(path, d), recursive=True)
                 for d in subdirs]
    if not snapshots:
        # no per-run subdirectories: the whole directory is one snapshot
        # (the single-baseline layout, found recursively)
        docs = load_docs(path, recursive=True)
        if docs:
            snapshots = [docs]
    return snapshots[-window:]


def row_key(section: str, row: dict) -> tuple:
    keys = SECTION_KEYS.get(section)
    if keys is None:                      # unknown section: best effort
        keys = tuple(k for k in ("app", "strategy", "name") if k in row)
    return tuple(str(row.get(k)) for k in keys)


def baseline_values(history: list[dict], section: str, key: tuple,
                    metric: str) -> list[float]:
    """This row's metric across every window snapshot that has it."""
    vals = []
    for snap in history:
        doc = snap.get(section)
        if doc is None:
            continue
        for row in doc.get("rows", []):
            if row_key(section, row) == key and metric in row:
                try:
                    vals.append(float(row[metric]))
                except (TypeError, ValueError):
                    pass
                break
    return vals


def compare(history: list[dict], current: dict[str, dict],
            threshold: float) -> list[str]:
    """Print deltas vs the window median; return regression descriptions."""
    regressions: list[str] = []
    for section, cur_doc in sorted(current.items()):
        n_base = sum(1 for snap in history if section in snap)
        if n_base == 0:
            print(f"== {section}: no baseline — "
                  f"{len(cur_doc.get('rows', []))} new rows, "
                  f"nothing to compare ==")
            continue
        print(f"== {section}: deltas vs median of {n_base} baseline "
              f"run{'s' if n_base != 1 else ''} ==")
        for row in cur_doc.get("rows", []):
            key = row_key(section, row)
            label = "/".join(key)
            parts = []
            matched = False
            for metric, direction in METRICS.items():
                if metric not in row:
                    continue
                vals = baseline_values(history, section, key, metric)
                if not vals:
                    continue
                matched = True
                a, b = median(vals), float(row[metric])
                if a == 0:
                    continue
                delta = (b - a) / abs(a)
                parts.append(f"{metric} {a:.2f}->{b:.2f} ({delta:+.1%})")
                worse = (direction < 0 and delta > threshold) or \
                        (direction > 0 and delta < -threshold)
                if worse:
                    regressions.append(
                        f"{section}/{label}: {metric} regressed vs "
                        f"median-of-{len(vals)} {a:.2f} -> {b:.2f} "
                        f"({delta:+.1%}, threshold {threshold:.0%})")
            if not matched:
                print(f"  {label}: new row")
            else:
                print(f"  {label}: "
                      + ("; ".join(parts) if parts else "no shared metrics"))
    return regressions


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", default="bench-baseline",
                    help="directory of per-run snapshot subdirectories (or "
                         "a single artifact directory/file) with previous "
                         "BENCH_*.json artifacts")
    ap.add_argument("--current", default=".",
                    help="directory (or file) with this run's artifacts")
    ap.add_argument("--threshold", type=float, default=0.20,
                    help="gated-metric regression tolerance (fraction)")
    ap.add_argument("--window", type=int, default=DEFAULT_WINDOW,
                    help="baseline snapshots to keep; the gate compares "
                         "against the median of the window")
    args = ap.parse_args(argv)

    current = load_docs(args.current)
    # the current artifacts must not gate against themselves when --current
    # is a directory that also holds the baseline snapshots
    if not current:
        print(f"# no BENCH_*.json artifacts under {args.current!r}; "
              f"run `python -m repro_torch.launch.run --json` first")
        return 1
    history = (load_history(args.baseline, window=args.window)
               if os.path.exists(args.baseline) else [])
    history = [snap for snap in history if snap]
    if not history:
        print(f"# no baseline artifacts under {args.baseline!r} — "
              f"first run of the trajectory, nothing to gate")
        return 0
    regressions = compare(history, current, args.threshold)
    if regressions:
        print(f"\n{len(regressions)} regression(s) over "
              f"{args.threshold:.0%} threshold:")
        for r in regressions:
            print(f"  REGRESSION {r}")
        return 1
    print("\n# no gated regressions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
