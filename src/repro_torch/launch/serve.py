"""Serving launcher of the port: plans the arch's block regions (with
``--auto-offload``), then serves synthetic requests through
``ServeEngine``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-nemo-12b \\
      [--reduced] [--auto-offload] [--device cpu]

With ``--auto-offload`` the launcher runs the block-level offload planner
(``models/offload_program.py``) first, against the plan cache
(``--plan-cache``), and serves with the selected pattern; only the first
launch on a given (arch, shapes, card) pays for the measurements.  The
footer prints the prefill steps built per bucket: CUDA-graph captures on
a card, first calls on the CPU (the JAX launcher's compilations).  The
port has no online replanning yet, so the JAX launcher's ``--replan-*``
and ``--verify-workers`` flags are absent.
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
from repro_torch.models import factory as F
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.sampling import SamplingParams

STRATEGIES = ("staged", "exhaustive", "auto")    # those the port has


def planned_impl(arch: str, cache: PlanCache, *, reps: int = 2,
                 strategy: str = "staged", tune_tiles: bool = False,
                 device=None) -> Impl:
    """Best cached or measured offload pattern for the arch's block
    regions (``make_lm_program``), planned on ``device``."""
    from repro_torch.models.offload_program import make_lm_program

    prog = make_lm_program(arch, device=device)
    offloader = AutoOffloader(PlannerConfig(reps=reps, strategy=strategy,
                                            tune_tiles=tune_tiles))
    report = offloader.plan(prog, cache=cache)
    src = ("plan cache" if report.from_cache
           else f"measured search [{report.strategy}]")
    print(f"auto-offload [{src}]: {report.best_pattern or 'all-ref'} "
          f"(speedup {report.speedup:.2f}x)")
    return Impl(report.best_pattern)


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
                    choices=STRATEGIES,
                    help="Step-4 search strategy for --auto-offload; part of "
                         "the plan-cache key")
    ap.add_argument("--tune-tiles", action="store_true",
                    help="search kernel tile parameters during "
                         "--auto-offload; part of the plan-cache key")
    ap.add_argument("--plan-cache",
                    default=os.environ.get(DEFAULT_CACHE_ENV,
                                           DEFAULT_CACHE_PATH),
                    help="plan-cache JSON path (used with --auto-offload; "
                         f"default honors ${DEFAULT_CACHE_ENV})")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    impl = None
    if args.auto_offload:
        impl = planned_impl(args.arch, PlanCache(args.plan_cache),
                            strategy=args.offload_strategy,
                            tune_tiles=args.tune_tiles, device=dev)
    params = F.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed))
    ctx = args.prompt_len + args.new_tokens
    engine = ServeEngine(cfg, params, slots=args.slots, ctx=ctx,
                         seed=args.seed, impl=impl)
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k)
    for r in range(args.requests):
        plen = args.prompt_len
        if args.vary_lengths:
            plen = max(1, args.prompt_len - (r % 4) * (args.prompt_len // 4))
        tokens, _ = F.synthetic_request(cfg, plen, seed=args.seed * 100_003 + r)
        engine.submit(tokens, max_new_tokens=args.new_tokens,
                      sampling=sampling)

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


if __name__ == "__main__":
    main()
