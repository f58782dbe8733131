"""Online-replanning benchmark on the port: hot-swap pause + pre/post-swap
throughput under drifted traffic, and the warm re-open's zero measurement
budget (the twin of ``benchmarks/replanning.py``).

Two rows, with the JAX benchmark's assertions:

* ``drift-swap`` — a ``ServeEngine`` under scripted drift (short prompts,
  then long prompts at a higher arrival rate) with a drift-triggered
  replanner that hot-swaps to the ``mlp_core=offload`` pattern.  The model
  is Mistral-NeMo-12B reduced, in float32 (the JAX benchmark's qwen2-72b is
  not in the port's model zoo).  Per-tick wall times are recorded; the row
  reports the swap tick's duration against the median steady-state tick
  (the swap is a pointer assignment: the new generation was built off the
  tick path) and decode throughput before vs after the swap.
* ``warm-reopen`` — the ``AutoOffloader`` plans a toy program twice under
  different regime conditions (``plan_extra``): a new plan-cache key, the
  same measurement key, so ledger priming leaves the second plan's
  measurement count at ZERO.

Run:  PYTHONPATH=src python -m repro_torch.launch.replanning \\
          [--device cuda] [--json PATH]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from statistics import median

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.device import backend_name, resolve_device
from repro_torch.core.loops import fori_loop
from repro_torch.core.plan_cache import (PlanCache, measurement_cache_key,
                                         plan_cache_key)
from repro_torch.core.planner import AutoOffloader, PlannerConfig
from repro_torch.core.program import OffloadableProgram, Region, meta
from repro_torch.core.regions import Impl, dispatch, register_variant, variants
from repro_torch.models import factory as F
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.replan import (DriftConfig, DriftDetector,
                                        ReplanConfig, Replanner)

ARCH = "mistral-nemo-12b"

# scripted drift: short prompts (bucket 8), then long prompts (bucket 16)
# at double the arrival rate — mirrors tests/serving_harness.py
PHASES = ((8, 1, 4, 7, 8), (10, 2, 12, 15, 12))   # (ticks, per_tick, lo, hi, new)


class _ScriptedReport:
    """The swap row measures the ENGINE, not the search: a scripted report
    keeps the search cost out of the tick timings."""

    def __init__(self, impl):
        self.best_pattern = dict(impl)
        self.best_seconds = 1e-6

    def best_impl(self):
        return Impl(self.best_pattern)


def bench_drift_swap(device, seed: int = 0) -> dict:
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    params = F.init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    engine = ServeEngine(cfg, params, slots=2, ctx=48, seed=seed)
    detector = DriftDetector(DriftConfig(
        window=4, bucket_l1=0.5, occupancy_delta=2.0, ratio_rel=100.0,
        hysteresis=2, cooldown=4))
    replanner = Replanner(
        lambda conditions: _ScriptedReport({"mlp_core": "offload"}),
        config=ReplanConfig(on_drift=True, background=False, window=4),
        detector=detector)
    engine.attach_replanner(replanner)

    rng = np.random.default_rng(seed)
    schedule = []
    for ticks, per_tick, lo, hi, new in PHASES:
        for _ in range(ticks):
            schedule.append([(rng.integers(1, 200, size=int(
                rng.integers(lo, hi + 1))).astype(np.int32), new)
                for _ in range(per_tick)])

    tick_s: list[float] = []
    decoded_at_tick: list[int] = []

    def timed_tick():
        t0 = time.perf_counter()
        engine.step()
        tick_s.append(time.perf_counter() - t0)
        decoded_at_tick.append(engine.stats(window=1)["decode_tokens"])

    for tick_reqs in schedule:
        for prompt, new in tick_reqs:
            engine.submit(prompt, max_new_tokens=new)
        timed_tick()
    while engine.busy and len(tick_s) < 2000:
        timed_tick()
    assert not engine.busy, "drain exceeded tick budget"
    assert engine.swaps >= 1, "scripted drift never produced a swap"

    swap_tick = engine.swap_ticks[0]            # 1-based == tick_s index + 1
    steady = sorted(tick_s)[: max(1, int(len(tick_s) * 0.9))]
    med = median(steady)
    swap_s = tick_s[swap_tick - 1]
    pre = sum(decoded_at_tick[: swap_tick - 1]) / max(
        sum(tick_s[: swap_tick - 1]), 1e-9)
    post = sum(decoded_at_tick[swap_tick - 1:]) / max(
        sum(tick_s[swap_tick - 1:]), 1e-9)
    # zero-downtime gates: the swap tick must look like a normal tick,
    # never like a build (~100x); the post-swap regime must keep at least
    # half the pre-swap throughput
    assert swap_s < 10 * med, (
        f"swap tick {swap_s*1e3:.1f} ms vs median {med*1e3:.1f} ms — "
        "a build leaked into the tick path")
    assert post >= 0.5 * pre, (
        f"post-swap throughput collapsed: {post:.1f} vs {pre:.1f} tok/s")
    return {
        "app": ARCH, "mode": "drift-swap",
        "swaps": engine.swaps,
        "swap_tick": swap_tick,
        "swap_tick_ms": swap_s * 1e3,
        "median_tick_ms": med * 1e3,
        "pre_swap_tok_s": pre,
        "post_swap_tok_s": post,
        "requests": engine.finished_total,
        "detector_fired": detector.fired,
    }


_REGION = "replan_bench"


def _toy_program(device, plan_extra=None) -> OffloadableProgram:
    if not variants(_REGION):
        def slow_ref(x):
            return fori_loop(0, 200, lambda i, acc: acc + 1e-6 * torch.sin(
                acc * 1e-3), x)

        register_variant(_REGION, "ref")(slow_ref)
        register_variant(_REGION, "offload")(lambda x: x * 1.0000001)

    def build(impl):
        return lambda x: dispatch(_REGION, impl, x)

    def sample(seed, dev):
        g = torch.Generator().manual_seed(seed)
        return (torch.randn(64, 64, generator=g).to(dev),)

    return OffloadableProgram(
        name="replan_bench_prog",
        regions=[Region(_REGION, variants(_REGION)["ref"],
                        (meta((64, 64), torch.float32),))],
        build=build, sample_inputs=sample, device=device,
        source_loop_count=1, plan_extra=dict(plan_extra or {}))


def bench_warm_reopen(device) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        cache = PlanCache(os.path.join(tmp, "plans.json"))
        planner = AutoOffloader(PlannerConfig(max_measurements=4, reps=2,
                                              warmup=0))
        prog_a = _toy_program(device, {"occupancy_band": "low",
                                       "dominant_bucket": 8})
        prog_b = _toy_program(device, {"occupancy_band": "high",
                                       "dominant_bucket": 16})
        backend = backend_name(device)
        assert plan_cache_key(prog_a, planner.config, backend) != \
            plan_cache_key(prog_b, planner.config, backend)
        assert measurement_cache_key(prog_a, backend) == \
            measurement_cache_key(prog_b, backend)
        t0 = time.perf_counter()
        rep_a = planner.plan(prog_a, cache=cache)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rep_b = planner.plan(prog_b, cache=cache)
        warm_s = time.perf_counter() - t0
    assert not rep_a.from_cache and len(rep_a.measurements) >= 1
    assert not rep_b.from_cache, "regime change must re-open the search"
    assert rep_b.measurements == [], (
        f"warm re-open spent {len(rep_b.measurements)} measurements — "
        "ledger priming broke")
    assert rep_b.reused, "re-opened search reused nothing"
    return {
        "app": "replan_bench", "mode": "warm-reopen",
        "n_measured_cold": len(rep_a.measurements),
        "n_measured_warm": len(rep_b.measurements),
        "n_reused_warm": len(rep_b.reused),
        "plan_ms_cold": cold_s * 1e3,
        "plan_ms_warm": warm_s * 1e3,
    }


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--json", default=None, metavar="PATH")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    rows = [bench_drift_swap(dev), bench_warm_reopen(dev)]
    r = rows[0]
    print(f"{'mode':>12} | {'swaps':>5} | {'swap tick':>10} | "
          f"{'median tick':>11} | {'tok/s pre->post':>16}")
    print(f"{r['mode']:>12} | {r['swaps']:>5} | "
          f"{r['swap_tick_ms']:>7.1f} ms | {r['median_tick_ms']:>8.1f} ms | "
          f"{r['pre_swap_tok_s']:>6.1f} -> {r['post_swap_tok_s']:>6.1f}")
    w = rows[1]
    print(f"{w['mode']:>12} | cold: {w['n_measured_cold']} measured in "
          f"{w['plan_ms_cold']:.0f} ms | warm re-open: "
          f"{w['n_measured_warm']} measured, {w['n_reused_warm']} reused in "
          f"{w['plan_ms_warm']:.0f} ms")
    if a.json:
        with open(a.json, "w") as fh:
            json.dump({"section": "replanning", "device": str(dev),
                       "rows": rows}, fh, indent=2)
        print(f"wrote {a.json}")
    return rows


if __name__ == "__main__":
    main()
