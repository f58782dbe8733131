"""Serving launcher of the port: plans the arch's block regions (with
``--auto-offload``), then serves synthetic requests through
``ServeEngine``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-nemo-12b \\
      [--reduced] [--auto-offload] [--device cpu]

``--arch`` takes every arch of the port's registry (``configs/base.py``:
the dense, MoE, SSM and hybrid decoders and the two frontends); those
larger than one card (the MoE archs, qwen2-72b, deepseek-67b) run there
only ``--reduced``.  Each request of a frontend arch carries its synthetic
patch embeddings (paligemma-3b; the cache holds the prefix too) or mel
frames (whisper-small).

With ``--auto-offload`` the launcher runs the block-level offload planner
(``models/offload_program.py``) first, against the plan cache
(``--plan-cache``), and serves with the selected pattern; only the first
launch on a given (arch, shapes, card) pays for the measurements.  The
footer prints the prefill steps built per bucket: CUDA-graph captures on
a card, first calls on the CPU (the JAX launcher's compilations).

``--replan-every N`` / ``--replan-on-drift`` attach an online replanner
(``serving/replan.py``): it re-opens the offload search on a background
thread while the engine ticks (``make_replan_fn``) and hot-swaps a
strictly-better, canary-checked plan between ticks.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.plan_cache import (DEFAULT_CACHE_ENV, DEFAULT_CACHE_PATH,
                                         PlanCache)
from repro_torch.core.planner import AutoOffloader, PlannerConfig
from repro_torch.core.regions import Impl
from repro_torch.core.strategies import STRATEGY_NAMES
from repro_torch.models import factory as F
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.sampling import SamplingParams


def make_offloader(reps: int = 2, strategy: str = "staged", seed: int = 0,
                   verify_workers: int = 1,
                   tune_tiles: bool = False) -> AutoOffloader:
    """One long-lived AutoOffloader for launch-time planning AND every
    online replan: its offloader-lifetime CompileCache keeps re-opened
    searches building nothing twice."""
    return AutoOffloader(PlannerConfig(
        reps=reps, strategy=strategy, seed=seed,
        verify_workers=verify_workers, tune_tiles=tune_tiles))


def planned_impl(arch: str, cache: PlanCache, *, reps: int = 2,
                 strategy: str = "staged", tune_tiles: bool = False,
                 device=None, offloader: AutoOffloader | None = None) -> Impl:
    """Best cached or measured offload pattern for the arch's block
    regions (``make_lm_program``), planned on ``device``.  Pass
    ``offloader`` to share one instance (and its CompileCache and
    quarantine) with an online replanner."""
    from repro_torch.models.offload_program import make_lm_program

    prog = make_lm_program(arch, device=device)
    if offloader is None:
        offloader = make_offloader(reps=reps, strategy=strategy,
                                   tune_tiles=tune_tiles)
    report = offloader.plan(prog, cache=cache)
    src = ("plan cache" if report.from_cache
           else f"measured search [{report.strategy}]")
    print(f"auto-offload [{src}]: {report.best_pattern or 'all-ref'} "
          f"(speedup {report.speedup:.2f}x)")
    return Impl(report.best_pattern)


def make_replan_fn(arch: str, offloader: AutoOffloader, cache: PlanCache,
                   default_seq: int = 128, device=None):
    """The production ``Replanner.plan_fn``: regime conditions from
    ``conditions_from_stats`` become the program's ``plan_extra`` (re-keying
    the plan per regime) and the dominant bucket becomes the measurement
    ``seq`` (timings reflect the live prompt lengths).  A regime shift that
    keeps the shapes re-opens the search fully ledger-primed.  The search
    runs while the engine ticks; its patterns are timed on a stream of
    their own (``search.time_callable``)."""
    from repro_torch.models.offload_program import make_lm_program

    def plan_fn(conditions: dict):
        seq = int(conditions.get("dominant_bucket") or 0) or default_seq
        prog = make_lm_program(arch, seq=max(seq, 8), device=device,
                               plan_extra=dict(conditions))
        return offloader.plan(prog, cache=cache)
    return plan_fn


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent decode slots")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--requests", type=int, default=12,
                    help="number of requests to serve")
    ap.add_argument("--vary-lengths", action="store_true",
                    help="stagger prompt lengths to exercise prefill buckets")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--auto-offload", action="store_true",
                    help="plan (or reuse the cached) offload pattern first")
    ap.add_argument("--offload-strategy", default="staged",
                    choices=list(STRATEGY_NAMES),
                    help="Step-4 search strategy for --auto-offload and the "
                         "replanner (staged = paper heuristic, genetic = GA "
                         "over mixed genomes, surrogate = roofline-predicted "
                         "fitness with top-k real measurements, exhaustive = "
                         "tiny-space oracle, auto = pick by space size); "
                         "part of the plan-cache key")
    ap.add_argument("--offload-seed", type=int, default=0,
                    help="strategy RNG seed; kept apart from --seed "
                         "(sampling) so the sampling seed never re-keys the "
                         "plan cache")
    ap.add_argument("--tune-tiles", action="store_true",
                    help="search kernel tile parameters during "
                         "--auto-offload; part of the plan-cache key")
    ap.add_argument("--verify-workers", type=int, default=1,
                    help="concurrent compile steps (nvcc builds) of the "
                         "planner's pattern verification; the selected "
                         "pattern is the same at any width")
    ap.add_argument("--plan-cache",
                    default=os.environ.get(DEFAULT_CACHE_ENV,
                                           DEFAULT_CACHE_PATH),
                    help="plan-cache JSON path (used with --auto-offload; "
                         f"default honors ${DEFAULT_CACHE_ENV})")
    ap.add_argument("--replan-every", type=int, default=0,
                    help="online replanning: re-open the offload search "
                         "every N engine ticks on a background thread and "
                         "hot-swap a strictly-better plan between ticks "
                         "(0 = off)")
    ap.add_argument("--replan-on-drift", action="store_true",
                    help="online replanning: re-plan when the live serving "
                         "regime (bucket mix, occupancy, decode/prefill "
                         "balance) drifts from the planned one")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    replanning = bool(args.replan_every or args.replan_on_drift)
    cache = PlanCache(args.plan_cache)
    offloader = None
    if args.auto_offload or replanning:
        offloader = make_offloader(strategy=args.offload_strategy,
                                   seed=args.offload_seed,
                                   verify_workers=args.verify_workers,
                                   tune_tiles=args.tune_tiles)
    impl = None
    if args.auto_offload:
        impl = planned_impl(args.arch, cache, device=dev,
                            offloader=offloader)
    params = F.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed))
    ctx = args.prompt_len + args.new_tokens + cfg.n_front
    engine = ServeEngine(cfg, params, slots=args.slots, ctx=ctx,
                         seed=args.seed, impl=impl)
    replanner = None
    if replanning:
        from repro_torch.serving.replan import ReplanConfig, Replanner
        # share the offloader's quarantine: a plan the engine rolled back
        # (or the canary vetoed) stops being proposed by the next search
        replanner = Replanner(
            make_replan_fn(args.arch, offloader, cache,
                           default_seq=args.prompt_len, device=dev),
            config=ReplanConfig(every_ticks=args.replan_every,
                                on_drift=args.replan_on_drift),
            quarantine=offloader.quarantine)
        engine.attach_replanner(replanner)
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k)
    for r in range(args.requests):
        plen = args.prompt_len
        if args.vary_lengths:
            plen = max(1, args.prompt_len - (r % 4) * (args.prompt_len // 4))
        tokens, frontend = F.synthetic_request(
            cfg, plen, seed=args.seed * 100_003 + r)
        engine.submit(tokens, max_new_tokens=args.new_tokens,
                      sampling=sampling, frontend=frontend)

    t0 = time.perf_counter()
    done = engine.run_to_completion()
    wall = time.perf_counter() - t0
    s = engine.stats()
    for req in done:
        print(f"req {req.rid}: prompt {req.tokens.size:4d} "
              f"(bucket {req.bucket:4d}) | wait {req.queue_wait_s*1e3:7.1f} ms "
              f"| ttft {req.ttft_s*1e3:7.1f} ms | decode "
              f"{req.decode_tps:8.1f} tok/s")
    print(f"served {s['requests_finished']} requests / "
          f"{s['generated_tokens']} tokens in {wall:.2f} s on {dev} "
          f"({s['generated_tokens']/wall:.1f} tok/s aggregate)")
    what = "captures" if dev.type == "cuda" else "first calls"
    print(f"prefill {what}: {s['prefill_traces']} (buckets {s['buckets']}); "
          f"serving pattern {engine.plan_impl.describe()}")
    if replanner is not None:
        replanner.close(timeout=60.0)
        rs = replanner.stats()
        print(f"replanning: {rs['replans']} search(es), "
              f"{rs['offers']} offered, {s['swaps']} swap(s) installed "
              f"(plan generation {s['plan_generation']})")
        if rs["canary_rejects"] or s["rollbacks"]:
            print(f"fault tolerance: {rs['canary_rejects']} canary "
                  f"reject(s), {s['rollbacks']} rollback(s)"
                  + (f" [degraded: {s['last_fault']}]"
                     if s["degraded"] else ""))
        if replanner.last_error is not None:
            print(f"replanner error: {replanner.last_error}")


if __name__ == "__main__":
    main()
