"""Kernel micro-benchmarks on the port: each variant of the model regions
timed on the device, beside its H100 roofline projection (the twin of
``benchmarks/kernel_bench.py``).  One row per (region, variant), CSV:
``name,us_per_call,derived``, where ``derived`` holds ``h100_proj_us`` (the
region's flops, boundary bytes and transcendentals from
``core/intensity.py::analyze_region`` at the published H100 peaks,
``launch/constants.py``), the bound, the speedup against ``ref`` and, for a
``hopper`` row, the kernel launches counted while it was timed.

The regions, shapes and types are the JAX benchmark's: ``attn_core``
float32 [2, 8/2, 1,024, 64] causal, ``rglru_scan`` float32 [4, 1,024, 512],
``ssm_scan`` float32 [2, 512, 256, 16] and ``mlp_core`` bf16 [512, 512] x
[512, 1,024].  On a card every call is timed with CUDA events after a
``torch.cuda.synchronize()`` (the median of ``--reps`` single calls after
a warm-up call); on the CPU with the host clock.  The ``hopper`` variants
are hand-written CUDA kernels, timed on a card only: on the CPU their row
says that the kernel was not run (a plain version is never timed under the
kernel's name).

    PYTHONPATH=src python -m repro_torch.launch.kernel_bench \\
        [--reps 5] [--device cpu --reduced] [--json PATH]

``--reduced`` runs every region at small shapes, for the CPU.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

import repro_torch.kernels.ops  # noqa: F401 (registers the hopper variants)
import repro_torch.models.blocks  # noqa: F401 (registers ref/offload)
import repro_torch.models.rglru  # noqa: F401
import repro_torch.models.ssm  # noqa: F401
from repro_torch.core.device import backend_name, resolve_device
from repro_torch.core.intensity import analyze_region
from repro_torch.core.regions import variants
from repro_torch.kernels import launch_counters
from repro_torch.launch.constants import (PEAK_FLOPS_BF16, PEAK_FLOPS_FP32,
                                          projected_seconds)

# (region, shapes at full size, shapes --reduced, kwargs); shapes are
# attn (b, hq, hkv, s, d), rglru (b, s, d), ssm (b, s, d, n), mlp (t, d, f)
CASES = (
    ("attn_core", (2, 8, 2, 1024, 64), (1, 4, 2, 64, 16), {"causal": True}),
    ("rglru_scan", (4, 1024, 512), (2, 32, 48), {}),
    ("ssm_scan", (2, 512, 256, 16), (1, 24, 32, 8), {}),
    ("mlp_core", (512, 512, 1024), (32, 32, 64), {}),
)


def make_args(region: str, shape, dev) -> tuple:
    """The region's inputs, drawn from a seeded generator on the CPU."""
    g = torch.Generator().manual_seed(0)

    def normal(*s, dtype=torch.float32, scale=1.0):
        return (torch.randn(s, generator=g) * scale).to(dev, dtype)

    def uniform(*s, lo, hi):
        return (lo + (hi - lo) * torch.rand(s, generator=g)).to(dev)

    if region == "attn_core":
        b, hq, hkv, s, d = shape
        return (normal(b, hq, s, d), normal(b, hkv, s, d),
                normal(b, hkv, s, d))
    if region == "rglru_scan":
        b, s, d = shape
        return (uniform(b, s, d, lo=0.6, hi=0.99), normal(b, s, d, scale=0.1),
                torch.zeros((b, d), device=dev))
    if region == "ssm_scan":
        b, s, d, n = shape
        return (uniform(b, s, d, n, lo=0.6, hi=0.99),
                normal(b, s, d, n, scale=0.1), normal(b, s, n),
                torch.zeros((b, d, n), device=dev))
    t, d, f = shape
    bf16 = torch.bfloat16
    return (normal(t, d, dtype=bf16), normal(d, f, dtype=bf16),
            normal(d, f, dtype=bf16), normal(f, d, dtype=bf16))


def time_call(fn, dev: torch.device, reps: int) -> float:
    """Median seconds of one call: CUDA events on a card, after a warm-up
    call and a synchronize; the host clock on the CPU."""
    fn()
    times = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def bench_region(region: str, args, kwargs, dev, reps: int) -> list[dict]:
    rows, base = [], None
    # ref first, the rest by name, as the JAX benchmark orders them
    names = sorted(variants(region), key=lambda v: (v != "ref", v))
    peak = (PEAK_FLOPS_BF16 if args[0].dtype == torch.bfloat16
            else PEAK_FLOPS_FP32)
    counters = launch_counters()
    for vname in names:
        fn = variants(region)[vname]

        def call(fn=fn):
            return fn(*args, **kwargs)

        name = f"{region}/{vname}"
        if vname == "hopper" and dev.type != "cuda":
            rows.append({"name": name, "us_per_call": None,
                         "ran": False, "launches": 0})
            continue
        ana = analyze_region(call, name=region)
        proj = projected_seconds(ana.flops, ana.boundary_bytes,
                                 ana.transcendentals, peak_flops=peak)
        before = sum(c.launches for c in counters)
        t = time_call(call, dev, reps)
        launches = sum(c.launches for c in counters) - before
        if vname == "ref":
            base = t
        rows.append({"name": name, "us_per_call": t * 1e6, "ran": True,
                     "h100_proj_us": proj["seconds"] * 1e6,
                     "bound": proj["bound"],
                     "speedup_vs_ref": base / t if base else None,
                     "launches": launches})
    return rows


def format_row(r: dict) -> str:
    if not r["ran"]:
        return (f"{r['name']},not run,hopper is a CUDA kernel: timed on a "
                "card only")
    derived = (f"h100_proj_us={r['h100_proj_us']:.2f};bound={r['bound']}"
               + (f";speedup_vs_ref={r['speedup_vs_ref']:.2f}"
                  if r["speedup_vs_ref"] else "")
               + (f";launches={r['launches']}"
                  if r["name"].endswith("/hopper") else ""))
    return f"{r['name']},{r['us_per_call']:.1f},{derived}"


def run(device=None, reduced: bool = False, reps: int = 5) -> list[dict]:
    dev = resolve_device(device)
    rows = []
    for region, full, small, kwargs in CASES:
        args = make_args(region, small if reduced else full, dev)
        rows += bench_region(region, args, kwargs, dev, reps)
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--reduced", action="store_true",
                    help="small shapes (for the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write a BENCH_kernels.json document here")
    a = ap.parse_args(argv)
    rows = run(a.device, a.reduced, a.reps)
    print("name,us_per_call,derived")
    for r in rows:
        print(format_row(r))
    if a.json:
        with open(a.json, "w") as f:
            json.dump({"section": "kernels",
                       "device": backend_name(resolve_device(a.device)),
                       "rows": rows}, f, indent=2, sort_keys=True)
        print(f"# wrote {a.json}")
    return rows


if __name__ == "__main__":
    main()
