"""Fault-tolerance benchmark on the port: the price of surviving a fault
storm, and the cost of a mid-serve rollback (the twin of
``benchmarks/faults.py``).

Two rows, with the JAX benchmark's hard assertions:

* ``fault-storm`` — the ``AutoOffloader`` plans a toy program of two
  regions twice: fault-free, then wrapped by a ``FaultInjector`` throwing
  a transient ``flaky`` failure at every pattern's first run and a
  permanent NaN at ``b=offload``.  At least one fault fires and at least
  one retry happens; the clean winner is {a, b: offload}, the storm's
  {a: offload}, and ``b=offload`` is quarantined.  The row reports the
  retries and the storm's wall overhead.
* ``rollback`` — a ``ServeEngine`` under 12 ticks of steady traffic is
  offered, at tick 6, a warm plan with ``mlp_core=poison`` (the ref times
  NaN).  Exactly one rollback, no request dropped, and the rollback tick
  under 10x the median tick (JAX's gate: rollback is a switch to a warm
  generation, not a build).

Rule P (``launch/paired.py``) governs the twins that compare two plans'
timings; here the winners are held to fixed patterns whose gaps are a
200-trip loop against one op, and quarantine and rollback are
deterministic, so nothing is re-timed and each row records
``"decided_by": "plan"``.

Sizes: ``--arch`` defaults to the JAX benchmark's qwen2-72b; with
``--reduced`` its reduced config runs in float32 (the CPU tests);
without, the full config in its own dtype on the card (``chip_smoke.py``
serves mistral-nemo-12b at full width in bf16); 2 slots either way, as
in JAX.

Run:  PYTHONPATH=src python -m repro_torch.launch.faults \\
          [--arch qwen2-72b] [--reduced] [--device cuda] [--json PATH]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from statistics import median

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.device import backend_name, resolve_device
from repro_torch.core.faults import FaultInjector, FaultSpec, wrap_program
from repro_torch.core.loops import fori_loop
from repro_torch.core.planner import AutoOffloader, PlannerConfig
from repro_torch.core.program import OffloadableProgram, Region, meta
from repro_torch.core.regions import (Impl, dispatch, register_variant,
                                      unregister_variant, variants)
from repro_torch.models import factory as F
from repro_torch.serving.engine import ServeEngine

ARCH = "qwen2-72b"
A, B = "faults_bench_a", "faults_bench_b"
SLOTS, TICKS, OFFER_TICK = 2, 12, 6


def _toy_program(device) -> OffloadableProgram:
    if not variants(A):
        def slow_ref(x):
            return fori_loop(0, 200, lambda i, acc: acc + 1e-6 * torch.sin(
                acc * 1e-3), x)

        for name in (A, B):
            register_variant(name, "ref")(slow_ref)
        register_variant(A, "offload")(lambda x: x * 1.0000001)
        register_variant(B, "offload")(lambda x: x - 1e-7)

    def build(impl):
        def run(x):
            return dispatch(B, impl, dispatch(A, impl, x))
        return run

    def sample(seed, dev):
        g = torch.Generator().manual_seed(seed)
        return (torch.randn(64, 64, generator=g).to(dev),)

    abstract = (meta((64, 64), torch.float32),)
    return OffloadableProgram(
        name="faults_bench_prog",
        regions=[Region(A, variants(A)["ref"], abstract),
                 Region(B, variants(B)["ref"], abstract)],
        build=build, sample_inputs=sample, device=device,
        source_loop_count=2)


def bench_fault_storm(device) -> dict:
    cfg = PlannerConfig(reps=2, warmup=0, retry_backoff_s=0.0,
                        compile_timeout_s=30.0, run_timeout_s=30.0,
                        quarantine_threshold=1)
    prog = _toy_program(device)

    t0 = time.perf_counter()
    clean = AutoOffloader(cfg).plan(prog)
    clean_s = time.perf_counter() - t0

    # the storm: every pattern's first timed run fails transiently, and
    # the b=offload gene is permanently broken (NaN output)
    inj = FaultInjector(specs=[
        FaultSpec("flaky", site="run", times=1),
        FaultSpec("nan", site="run", match=f"{B}=offload", times=0,
                  transient=False),
    ])
    t0 = time.perf_counter()
    storm = AutoOffloader(cfg).plan(wrap_program(prog, inj))
    storm_s = time.perf_counter() - t0

    n_injected = inj.fired()
    measurements = storm.measurements + (
        [storm.baseline] if storm.baseline is not None else [])
    n_retries = sum(max(0, m.attempts - 1) for m in measurements)
    assert n_injected > 0, "the storm never fired"
    assert n_retries > 0, "transient faults were injected but never retried"
    # the storm costs retries, never correctness: the clean winner less
    # the permanently broken gene
    assert clean.best_pattern == {A: "offload", B: "offload"}, (
        f"clean winner {clean.best_pattern}")
    assert storm.best_pattern == {A: "offload"}, (
        f"storm winner {storm.best_pattern}: the healthy gene must win and "
        "the NaN gene must not")
    assert f"{B}=offload" in storm.quarantined, (
        f"NaN gene missing from quarantine: {storm.quarantined}")
    return {
        "app": "faults_bench", "mode": "fault-storm",
        "n_faults_injected": n_injected,
        "n_retries": n_retries,
        "n_quarantined": len(storm.quarantined),
        "plan_ms_clean": clean_s * 1e3,
        "plan_ms_storm": storm_s * 1e3,
        "storm_overhead_x": storm_s / max(clean_s, 1e-9),
        "speedup": storm.speedup,
        "best_pattern": Impl(storm.best_pattern).describe(),
        "quarantined": list(storm.quarantined),
        "decided_by": "plan",
    }


def _poison_mlp(*args, **kwargs):
    return variants("mlp_core")["ref"](*args, **kwargs) * float("nan")


def bench_rollback(device, arch: str = ARCH, reduced: bool = True,
                   seed: int = 0) -> dict:
    cfg = get_config(arch)
    if reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    params = F.init_params(cfg, torch.Generator(device=device).manual_seed(
        seed))
    engine = ServeEngine(cfg, params, slots=SLOTS, ctx=48, seed=seed)
    register_variant("mlp_core", "poison")(_poison_mlp)
    try:
        rng = np.random.default_rng(seed)
        # steady traffic: TICKS ticks x 1 request, short prompts
        schedule = [[(rng.integers(1, 200, size=int(
            rng.integers(4, 8))).astype(np.int32), 8)] for _ in range(TICKS)]

        tick_s: list[float] = []
        submitted = 0
        rollback_tick = None

        def tick():
            t0 = time.perf_counter()
            engine.step()
            tick_s.append(time.perf_counter() - t0)

        for i, tick_reqs in enumerate(schedule):
            for prompt, new in tick_reqs:
                engine.submit(prompt, max_new_tokens=new)
                submitted += 1
            if i == OFFER_TICK:
                # warm, as the replanner prepares a plan: the candidate's
                # steps are built off the tick path, so the timed fault
                # tick holds detection, rollback and the retry only
                engine.offer_plan(
                    engine.prepare_plan({"mlp_core": "poison"}, warm=True))
            tick()
            if rollback_tick is None and engine.rollbacks:
                rollback_tick = len(tick_s)
        while engine.busy and len(tick_s) < 2000:
            tick()
        assert not engine.busy, "drain exceeded tick budget"
        assert engine.rollbacks == 1, (
            f"expected exactly one rollback, got {engine.rollbacks}")
        assert rollback_tick is not None
        done = engine.finished_total
        assert done == submitted, (
            f"rollback dropped requests: {done}/{submitted} finished")

        steady = sorted(tick_s)[: max(1, int(len(tick_s) * 0.9))]
        med = median(steady)
        rb_s = tick_s[rollback_tick - 1]
        assert rb_s < 10 * med, (
            f"rollback tick {rb_s * 1e3:.1f} ms vs median {med * 1e3:.1f} ms"
            " — rollback leaked a build into the tick path")
        return {
            "app": arch, "mode": "rollback",
            "rollbacks": engine.rollbacks,
            "rollback_tick": rollback_tick,
            "rollback_tick_ms": rb_s * 1e3,
            "median_tick_ms": med * 1e3,
            "requests": done,
            "decided_by": "plan",
        }
    finally:
        unregister_variant("mlp_core", "poison")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=ARCH, help="the served model")
    ap.add_argument("--reduced", action="store_true",
                    help="its reduced config in float32 (for the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--json", default=None, metavar="PATH")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    rows = [bench_fault_storm(dev),
            bench_rollback(dev, a.arch, a.reduced)]
    s = rows[0]
    print(f"{'mode':>12} | {'injected':>8} | {'retries':>7} | "
          f"{'quarantined':>11} | {'plan clean->storm':>18}")
    print(f"{s['mode']:>12} | {s['n_faults_injected']:>8} | "
          f"{s['n_retries']:>7} | {s['n_quarantined']:>11} | "
          f"{s['plan_ms_clean']:>6.0f} -> {s['plan_ms_storm']:>6.0f} ms "
          f"({s['storm_overhead_x']:.2f}x)")
    r = rows[1]
    print(f"{r['mode']:>12} | {r['app']}: rollback tick "
          f"{r['rollback_tick_ms']:.1f} ms vs median "
          f"{r['median_tick_ms']:.1f} ms | {r['requests']} requests, "
          "0 dropped")
    if a.json:
        with open(a.json, "w") as fh:
            json.dump({"section": "faults", "backend": backend_name(dev),
                       "rows": rows}, fh, indent=2)
        print(f"wrote {a.json}")
    return rows


if __name__ == "__main__":
    main()
