"""Roofline analysis over the port's dry-run JSONL (one row per (arch,
shape, mesh)) — the twin of the JAX package's ``benchmarks/roofline.py``,
with an H100's figures (``launch/constants.py``).

Terms, per device (the dry-run counts rank 0's local work):
    compute    = flops / PEAK_FLOPS_BF16
    memory     = hbm_fused bytes / HBM_BW
    collective = collective bytes / INTER_NODE_BW

Every axis of a 16-wide production mesh spans more than one 8-GPU node,
so each collective crosses nodes and the collective term reads the
inter-node rate (one 400 Gb/s ConnectX-7 a GPU), not NVLink's.
MODEL_FLOPS = 6*N_active*tokens (train) or 2*N_active*tokens (serve).
``roofline_fraction`` = MODEL_FLOPS time at peak / dominant term.  These
are H100 data-sheet projections of the dry-run's counts, not
measurements.

    PYTHONPATH=src python -m repro_torch.launch.roofline --in dryrun.jsonl
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch.constants import (HBM_BW, INTER_NODE_BW,
                                          PEAK_FLOPS_BF16)


def model_flops(arch: str, shape_name: str, reduced: bool = False) -> float:
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    shape = SHAPES[shape_name]
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: one token/seq


def roofline_row(rec: dict) -> dict | None:
    if rec.get("status") != "ok" or "hlo_cost" not in rec:
        return None
    chips = rec["devices"]
    hc = rec["hlo_cost"]
    terms = {"compute": hc["flops"] / PEAK_FLOPS_BF16,
             "memory": hc.get("hbm_fused", hc["hbm_bytes"]) / HBM_BW,
             "collective": hc["total_collective_bytes"] / INTER_NODE_BW}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec["arch"], rec["shape"], rec.get("reduced", False))
    step_time = max(terms.values())
    mem = rec["memory"]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "chips": chips,
        "compute_s": terms["compute"], "memory_s": terms["memory"],
        "collective_s": terms["collective"],
        "memory_raw_s": hc["hbm_bytes"] / HBM_BW,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_global": hc["flops"] * chips,
        "flops_ratio": mf / max(hc["flops"] * chips, 1.0),
        "roofline_fraction": (mf / (chips * PEAK_FLOPS_BF16)
                              / max(step_time, 1e-30)),
        "hbm_gb_per_chip": (mem["argument_bytes"] + mem["temp_bytes"]) / 1e9,
        "step_time_s": step_time,
    }


def load_rows(path: str) -> list[dict]:
    """The roofline row of each cell's latest ok record."""
    rows: dict = {}
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            row = roofline_row(rec)
            if row is not None:
                rows[(row["arch"], row["shape"], row["mesh"])] = row
    return list(rows.values())


def format_table(rows: list[dict], mesh: str = "single") -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'compute_s':>10s} {'memory_s':>10s} "
           f"{'coll_s':>10s} {'bound':>10s} {'MF/HLO':>7s} {'roofline%':>9s} "
           f"{'HBM GB':>7s}")
    lines = [hdr, "-" * len(hdr)]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r["mesh"] != mesh:
            continue
        lines.append(
            f"{r['arch']:22s} {r['shape']:12s} {r['compute_s']:10.4f} "
            f"{r['memory_s']:10.4f} {r['collective_s']:10.4f} "
            f"{r['dominant']:>10s} {r['flops_ratio']:7.2f} "
            f"{100 * r['roofline_fraction']:8.1f}% "
            f"{r['hbm_gb_per_chip']:7.1f}")
    return "\n".join(lines)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--in", dest="inp", default="results/dryrun_torch.jsonl")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--csv", action="store_true")
    args = ap.parse_args(argv)
    rows = load_rows(args.inp)
    if args.csv:
        print("arch,shape,mesh,chips,compute_s,memory_s,collective_s,"
              "dominant,flops_ratio,roofline_fraction,hbm_gb_per_chip")
        for r in rows:
            print(f"{r['arch']},{r['shape']},{r['mesh']},{r['chips']},"
                  f"{r['compute_s']:.6f},{r['memory_s']:.6f},"
                  f"{r['collective_s']:.6f},{r['dominant']},"
                  f"{r['flops_ratio']:.3f},{r['roofline_fraction']:.4f},"
                  f"{r['hbm_gb_per_chip']:.2f}")
    else:
        print(format_table(rows, args.mesh))
    return rows


if __name__ == "__main__":
    main()
