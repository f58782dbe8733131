"""Serving launcher on the port: continuous-batching decode through
``ServeEngine`` — bucketed prefill, admission control, pluggable sampling,
lifecycle stats (the twin of ``examples/serve_lm.py``).

The model is the arch at full width by default, as ``launch.serve`` builds
it (random weights from ``--seed``); ``--reduced`` serves the arch's
reduced config, for the CPU (the JAX example always reduces).  Each
request of a frontend arch carries its synthetic patches or mel frames
(``submit(frontend=...)``).

    PYTHONPATH=src python -m repro_torch.launch.serve_lm \\
        [--arch recurrentgemma-2b] [--temperature 0.7 --top-k 20] \\
        [--device cpu --reduced]
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the arch's reduced config (for the CPU)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
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
    ctx = args.prompt_len + args.new_tokens + cfg.n_front
    engine = ServeEngine(cfg, params, slots=args.slots, ctx=ctx,
                         seed=args.seed)
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k)
    for r in range(args.requests):
        tokens, frontend = F.synthetic_request(
            cfg, args.prompt_len, seed=args.seed * 100_003 + r)
        engine.submit(tokens, max_new_tokens=args.new_tokens,
                      sampling=sampling, frontend=frontend)

    t0 = time.perf_counter()
    done = engine.run_to_completion()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    s = engine.stats()
    built = "CUDA-graph captures" if dev.type == "cuda" else "first calls"
    print(f"arch={cfg.name} slots={args.slots} requests={args.requests} "
          f"on {dev}")
    print(f"ttft: {s['ttft_s_mean'] * 1e3:.1f} ms mean (includes the "
          f"{built} of the first request per bucket)")
    print(f"decode: {s['decode_tps_mean']:.1f} tok/s/request mean | "
          f"{s['generated_tokens'] / wall:.1f} tok/s aggregate")
    print(f"prefill {built}: {s['prefill_traces']} (buckets {s['buckets']})")
    print("generated token ids (first request):", done[0].generated[:16])
    return {"stats": s, "done": done, "wall_s": wall}


if __name__ == "__main__":
    main()
