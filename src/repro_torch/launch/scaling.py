"""Weak-scaling table over the port's dry-run JSONL: single-pod (256) vs
multi-pod (512) per cell — the twin of the JAX package's
``benchmarks/scaling.py``, on ``launch/roofline.py``'s H100 projection.

Scaling speedup = t_single / t_multi of the dominant roofline term (fixed
global batch, so perfect weak scaling across the pod axis would halve
every per-device term: 2.0 is ideal; below 2.0 measures the collective
overhead the 'pod' axis adds).  H100 data-sheet projections, not
measurements.

    PYTHONPATH=src python -m repro_torch.launch.scaling --in dryrun.jsonl
"""
from __future__ import annotations

import argparse

from repro_torch.launch.roofline import load_rows


def scaling_rows(rows: list[dict]) -> list[dict]:
    """(arch, shape, 1-pod bound, 2-pod bound, speedup) of every cell with
    both meshes."""
    by_cell: dict = {}
    for r in rows:
        by_cell.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    out = []
    for (arch, shape), m in sorted(by_cell.items()):
        if "single" not in m or "multi" not in m:
            continue
        t1, t2 = m["single"]["step_time_s"], m["multi"]["step_time_s"]
        if t2 > 0:
            out.append({"arch": arch, "shape": shape, "single_s": t1,
                        "multi_s": t2, "speedup": t1 / t2})
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--in", dest="inp", default="results/dryrun_torch.jsonl")
    args = ap.parse_args(argv)
    out = scaling_rows(load_rows(args.inp))
    print(f"{'arch':22s} {'shape':12s} {'1-pod bound(s)':>15s} "
          f"{'2-pod bound(s)':>15s} {'speedup':>8s} {'ideal':>6s}")
    for r in out:
        print(f"{r['arch']:22s} {r['shape']:12s} {r['single_s']:15.4f} "
              f"{r['multi_s']:15.4f} {r['speedup']:8.2f} {'2.00':>6s}")
    return out


if __name__ == "__main__":
    main()
