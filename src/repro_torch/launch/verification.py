"""Serial vs pipelined pattern verification on the port (the twin of
``benchmarks/verification.py``; ``core/executor.py``).

The paper's Step 4 is bound by per-pattern compilation (~3 h per FPGA
pattern), and Yamato's method compiles candidate patterns in parallel.
The SAME multi-pattern search (>= 6 measured patterns, exhaustive at
d=8) is planned with ``verify_workers=1`` (serial) and ``verify_workers=N``
(concurrent compile steps, strictly serial timed reps), and a third time
through the pipelined plan's ``AutoOffloader``, whose lifetime
``CompileCache`` hands every pattern its built callable (a warm re-plan).
A throw-away plan comes first.  The hard invariants, as in JAX: the same
measured pattern sequence and the same ``n_measured`` (at least 6) in all
three plans, and the same winner (rule P below).

The program: 3 regions, each with a loop-faithful ``ref`` (a 300-trip
``fori_loop``) and an ``offload`` made of a DEPTH-18 unrolled chain of
products on a 48x48 operand.  On the port a pattern's compile step is
``search.compile_pattern``: the ``nvcc`` builds of the CUDA sources its
``hopper`` genes launch, then ``program.build``.  These regions have no
``hopper`` variant, so on the card the compile wall is the Python closures
``program.build`` returns (no ``nvcc`` run, nothing traced): the workers
ratio and the warm ratio are report-only, as in JAX, unless
``--min-speedup`` is given, and the host's CPU count is printed beside
them.  No artificial cost is added.

Rule P (``launch/paired.py``), for the same-winner claim: each plan
measures on its own (no plan is handed another plan's medians); when the
winners differ, the three plans are made once more (JAX's one retry); when
they still differ, the serial winner A and the other plan's winner B are
built once from one program instance on one input, warmed with one call
each, and timed in 5 rounds of A, B, B, A (CUDA events after a synchronize
on a card, the host clock on the CPU); the claim passes when the median of
(B1 + B2) / (A1 + A2) lies within [1/1.05, 1.05].  Each row records
``decided_by`` (``plan``, ``retry`` or ``paired``) and, when it ran,
``paired_ratio``.  On the CPU the same-winner claim is reported, not
asserted.

``--reduced`` (for the CPU) cuts the ref loop to 50 trips and the chain to
depth 6; the search, its budget and its assertions are the same.  With
``--json PATH`` the rows land in a ``BENCH_verification.json`` document
(``launch/trend.py``).

Run:  PYTHONPATH=src python -m repro_torch.launch.verification \\
          [--workers 4] [--device cuda] [--reduced] [--json PATH]
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.core.device import backend_name, resolve_device
from repro_torch.core.loops import fori_loop
from repro_torch.core.planner import AutoOffloader, PlannerConfig
from repro_torch.core.program import OffloadableProgram, Region, meta
from repro_torch.core.regions import (Impl, dispatch, register_variant,
                                      variants)
from repro_torch.launch import paired

APP = "veribench"
N_REGIONS = 3
DEPTH = 18          # unrolled chain length per offload variant
SIZE = 48           # operand side; small so runs are cheap, compiles are not
REF_TRIPS = 300
# --reduced: a shorter loop and chain for the CPU
REDUCED_DEPTH, REDUCED_TRIPS = 6, 50
# the (depth, trips) the regions' variants are registered with: a
# registration bumps the registry version, which keys the compile cache
_REGISTERED = [None]


def _slow_ref(trips: int):
    def fn(x):
        return fori_loop(0, trips,
                         lambda i, acc: acc + 1e-6 * torch.sin(acc * 1e-3), x)
    return fn


def _heavy_offload(salt: int, depth: int):
    """A deep unrolled chain on a small operand: a large program for the
    compile step, a small cost at run time."""
    def fn(x):
        y = x
        for k in range(depth):
            y = torch.tanh(y @ x * (1.0 + (salt + k) * 1e-6)) + y * 1e-3
        return y * 1e-3 + x
    return fn


def _region_names() -> list[str]:
    return [f"{APP}_r{i}" for i in range(N_REGIONS)]


def make_program(device=None, reduced: bool = False) -> OffloadableProgram:
    """The 3-region program on ``device``: the exhaustive search over its
    7-pattern non-ref space measures >= 6 distinct patterns.  Registers
    the regions' variants on first use (and again when ``reduced``
    changes)."""
    depth, trips = ((REDUCED_DEPTH, REDUCED_TRIPS) if reduced
                    else (DEPTH, REF_TRIPS))
    names = _region_names()
    if _REGISTERED[0] != (depth, trips):
        for i, name in enumerate(names):
            register_variant(name, "ref")(_slow_ref(trips))
            register_variant(name, "offload")(_heavy_offload(i, depth))
        _REGISTERED[0] = (depth, trips)

    def build(impl):
        def run(x):
            for name in names:
                x = dispatch(name, impl, x)
            return x
        return run

    def sample(seed, dev):
        g = torch.Generator().manual_seed(seed)
        return (torch.randn(SIZE, SIZE, generator=g).to(dev),)

    abstract = (meta((SIZE, SIZE), torch.float32),)
    return OffloadableProgram(
        name=APP, regions=[Region(n, variants(n)["ref"], abstract)
                           for n in names],
        build=build, sample_inputs=sample, device=resolve_device(device),
        source_loop_count=N_REGIONS, cache_extra={"depth": depth,
                                                  "trips": trips},
        description="compile-heavy synthetic app for verification pipelining")


def _cache_hits(rep) -> int:
    return sum(t.get("compile_cache_hits", 0) for t in rep.search_trace
               if "workers" in t)


def plan_with_workers(make, workers: int, budget: int, reps: int,
                      offloader: AutoOffloader | None = None
                      ) -> tuple[dict, AutoOffloader]:
    """One full plan at the given executor width: a FRESH AutoOffloader
    (no compile cache shared between the serial and pipelined plans)
    unless ``offloader`` is passed, as the warm re-plan does."""
    cfg = PlannerConfig(max_measurements=budget, reps=reps, warmup=1,
                        strategy="exhaustive", verify_workers=workers)
    cached = offloader is not None
    if offloader is None:
        offloader = AutoOffloader(cfg)
    else:
        offloader.config = cfg
    rep = offloader.plan(make())
    row = {
        "app": APP,
        "workers": workers,
        "cached_replan": cached,
        "n_measured": len(rep.measurements),
        "patterns": [m.pattern for m in rep.measurements],
        "run_seconds": {m.pattern: m.run_seconds for m in rep.measurements},
        "compile_seconds": {m.pattern: m.compile_seconds
                            for m in rep.measurements},
        "compile_wall_s": rep.compile_wall_s,
        "verify_wall_s": rep.verify_wall_s,
        "compile_cache_hits": _cache_hits(rep),
        "best_pattern": dict(rep.best_pattern),
        "best_ms": rep.best_seconds * 1e3,
        "baseline_ms": rep.baseline.run_seconds * 1e3,
        "speedup_vs_baseline": rep.speedup,
    }
    return row, offloader


def run(make, workers: int = 4, budget: int = 8,
        reps: int = 3) -> list[dict]:
    """The serial, pipelined and warm rows, each with ``decided_by``
    (rule P)."""
    # a throw-away plan pays the process's one-time costs (allocator,
    # first launches) so neither measured plan inherits them
    plan_with_workers(make, 1, budget=budget, reps=1)
    for attempt in ("plan", "retry"):
        serial, _ = plan_with_workers(make, 1, budget=budget, reps=reps)
        piped, warm_off = plan_with_workers(make, workers, budget=budget,
                                            reps=reps)
        # re-verification through the AutoOffloader-lifetime CompileCache:
        # the same search runs again (no plan cache), every pattern built
        warm, _ = plan_with_workers(make, workers, budget=budget, reps=reps,
                                    offloader=warm_off)
        if serial["best_pattern"] == piped["best_pattern"] \
                == warm["best_pattern"]:
            break
        if attempt == "plan":
            print("# winner mismatch between plans: retrying once")
    rows = (serial, piped, warm)
    for r in rows:
        r["decided_by"] = attempt
        if r is not serial and r["best_pattern"] != serial["best_pattern"]:
            ratio = paired.retime(make(), serial["best_pattern"],
                                  r["best_pattern"])
            r["decided_by"], r["paired_ratio"] = "paired", ratio
            print(f"# workers={r['workers']} cached={r['cached_replan']}: "
                  f"winner {r['best_pattern']} against serial "
                  f"{serial['best_pattern']}: paired ratio {ratio:.4f} "
                  f"(tie within [{1 / paired.TIE:.4f}, {paired.TIE}])")
    return list(rows)


def check(rows: list[dict], timed: bool = True) -> None:
    """The hard invariants: pipelining and the compile cache change the
    wall clock, never the measured sequence, the counts or (when
    ``timed``, by rule P) the winner."""
    serial, piped, warm = rows
    for r in (piped, warm):
        assert r["patterns"] == serial["patterns"], (
            f"measured pattern sequence diverged:\n  serial "
            f"{serial['patterns']}\n  workers={r['workers']} "
            f"cached={r['cached_replan']} {r['patterns']}")
        assert r["n_measured"] == serial["n_measured"] >= 6, (
            f"expected >= 6 identically-counted measured patterns, got "
            f"{serial['n_measured']} vs {r['n_measured']}")
        if not timed:
            continue
        if r["decided_by"] == "paired":
            assert paired.ties(r["paired_ratio"]), (
                f"selection diverged: {serial['best_pattern']} vs "
                f"{r['best_pattern']}, paired ratio {r['paired_ratio']:.4f} "
                f"outside [{1 / paired.TIE:.4f}, {paired.TIE}]")
        else:
            assert r["best_pattern"] == serial["best_pattern"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=4,
                    help="verify_workers of the pipelined plan")
    ap.add_argument("--budget", type=int, default=8,
                    help="measurement budget d (>= 7 covers the whole space)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--min-speedup", type=float, default=None,
                    help="fail below this wall-clock ratio; default: "
                         "report-only (the ratio is bound by the host)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--reduced", action="store_true",
                    help="a shorter ref loop and chain (for the CPU)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write a BENCH_verification.json document here")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    rows = run(lambda: make_program(dev, a.reduced), workers=a.workers,
               budget=a.budget, reps=a.reps)
    # the host clock of a shared CPU decides no timing claim
    check(rows, timed=dev.type == "cuda")
    serial, piped, warm = rows
    speedup = (serial["verify_wall_s"] / piped["verify_wall_s"]
               if piped["verify_wall_s"] > 0 else float("inf"))
    warm_speedup = (serial["verify_wall_s"] / warm["verify_wall_s"]
                    if warm["verify_wall_s"] > 0 else float("inf"))
    rel_dev = max(
        abs(piped["run_seconds"][p] - serial["run_seconds"][p])
        / max(serial["run_seconds"][p], 1e-12)
        for p in serial["run_seconds"])

    print("app,workers,cached,n_measured,verify_wall_s,compile_wall_s,"
          "best_ms,pattern,decided_by")
    for r in rows:
        pat = Impl(r["best_pattern"]).describe()
        print(f"{r['app']},{r['workers']},{int(r['cached_replan'])},"
              f"{r['n_measured']},{r['verify_wall_s']:.3f},"
              f"{r['compile_wall_s']:.3f},{r['best_ms']:.3f},{pat},"
              f"{r['decided_by']}")
    print(f"# pipeline speedup (verification wall-clock, "
          f"{piped['workers']} vs 1 workers): {speedup:.2f}x over "
          f"{serial['n_measured']} measured patterns")
    print(f"# compile-cache re-plan speedup (built callables, same "
          f"search): {warm_speedup:.2f}x; {warm['compile_cache_hits']} "
          f"compile-cache hits")
    print(f"# same winner: True; max run_seconds median deviation vs "
          f"serial: {rel_dev:.1%}")
    ncpu = os.cpu_count() or 1
    if a.min_speedup is not None:
        verdict = "PASS" if speedup >= a.min_speedup else "FAIL"
        print(f"# gate: speedup {speedup:.2f}x vs required "
              f"{a.min_speedup:.2f}x -> {verdict} ({ncpu} CPUs visible)")
        assert speedup >= a.min_speedup, (
            f"pipelined verification speedup {speedup:.2f}x below the "
            f"{a.min_speedup:.2f}x gate")
    else:
        print(f"# gate: report-only ({ncpu} CPU(s) visible; the compile "
              f"step of these regions is program.build alone)")
    doc = {
        "section": "verification",
        "backend": backend_name(dev),
        "cpus": ncpu,
        "budget": a.budget,
        "pipeline_speedup": speedup,
        "cached_replan_speedup": warm_speedup,
        "identical_winner": all(r["decided_by"] != "paired" for r in rows),
        "max_run_seconds_rel_dev": rel_dev,
        "rows": rows,
    }
    if a.json:
        with open(a.json, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        print(f"# wrote {a.json}")
    return doc


if __name__ == "__main__":
    main()
