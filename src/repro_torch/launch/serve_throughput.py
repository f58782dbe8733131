"""Serving throughput of the port: tokens/s and TTFT across slot counts —
the twin of the JAX package's ``benchmarks/serve_throughput.py``.

Drives ``ServeEngine`` with a mixed-length request stream (6 distinct
prompt lengths over the prefill buckets 8 and 16) and prints, per slot
count: aggregate tokens/s, TTFT mean / p50, queue wait, the windowed
occupancy and decode/prefill ratio (the regime a replanner watches), and
how many prefill steps the buckets cost — CUDA-graph captures on a card,
first calls on the CPU (the JAX benchmark's compilations).

  PYTHONPATH=src python -m repro_torch.launch.serve_throughput \\
      [--arch mistral-nemo-12b] [--reduced] [--slots 1,4] [--device cpu]

Without ``--device cpu`` it needs a card; without ``--reduced`` it builds
the full model.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.core.device import resolve_device
from repro_torch.models import factory as F
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.sampling import SamplingParams

# mixed prompt lengths: 6 distinct lengths over 2 buckets (8, 16)
PROMPT_LENGTHS = (5, 7, 9, 11, 13, 15)


def bench_one(cfg, params, *, slots: int, requests: int, new_tokens: int,
              ctx: int, temperature: float, seed: int) -> dict:
    """Serve ``requests`` synthetic requests on a fresh engine; returns its
    ``stats()`` plus ``wall_s``, ``tok_per_s`` and the whole run's
    windowed ``occupancy_mean`` and ``decode_prefill_ratio``."""
    engine = ServeEngine(cfg, params, slots=slots, ctx=ctx, seed=seed)
    sampling = SamplingParams(temperature=temperature)
    for r in range(requests):
        plen = PROMPT_LENGTHS[r % len(PROMPT_LENGTHS)]
        tokens, frontend = F.synthetic_request(cfg, plen,
                                               seed=seed * 100_003 + r)
        engine.submit(tokens, max_new_tokens=new_tokens, sampling=sampling,
                      frontend=frontend)
    t0 = time.perf_counter()
    engine.run_to_completion()          # every token sampled to the host
    wall = time.perf_counter() - t0
    s = engine.stats()
    w = engine.stats(window=engine.ticks)
    s["wall_s"] = wall
    s["tok_per_s"] = s["generated_tokens"] / wall
    s["occupancy_mean"] = w["occupancy_mean"]
    s["decode_prefill_ratio"] = w["decode_prefill_ratio"]
    return s


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mistral-nemo-12b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", default="1,4",
                    help="comma-separated slot counts to sweep")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--ctx", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = F.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed))
    slot_counts = [int(s) for s in args.slots.split(",")]
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    what = "prefill captures" if dev.type == "cuda" else "prefill first calls"
    print(f"arch={cfg.name} device={where} requests={args.requests} "
          f"new_tokens={args.new_tokens} ctx={args.ctx} "
          f"prompt_lengths={sorted(set(PROMPT_LENGTHS))}")
    print(f"{'slots':>5} | {'tok/s':>8} | {'ttft ms (mean/p50)':>18} | "
          f"{'wait ms':>8} | {'occ':>5} | {'dec/pre':>7} | {what}")
    for slots in slot_counts:
        s = bench_one(cfg, params, slots=slots, requests=args.requests,
                      new_tokens=args.new_tokens, ctx=args.ctx,
                      temperature=args.temperature, seed=args.seed)
        print(f"{slots:>5} | {s['tok_per_s']:>8.1f} | "
              f"{s['ttft_s_mean']*1e3:>8.1f} / {s['ttft_s_p50']*1e3:>6.1f} | "
              f"{s['queue_wait_s_mean']*1e3:>8.1f} | "
              f"{s['occupancy_mean']:>5.2f} | "
              f"{s['decode_prefill_ratio']:>7.2f} | "
              f"{s['prefill_traces']:>4} for buckets {s['buckets']}")


if __name__ == "__main__":
    main()
