"""Beyond the paper, on the port: the offload planner applied to
transformer blocks (the twin of ``examples/offload_transformer.py``).

The paper closes by proposing to extend offloading from loop statements to
larger functional blocks.  ``models/offload_program.py`` builds the
block-level program, so the serving launcher (``launch.serve
--auto-offload``) plans over the same regions; this launcher runs the
planner on its own and reuses the persistent plan cache.  As in the JAX
package, the regions are analysed at the full architecture's shapes and
Step 4 measures the reduced model.

    PYTHONPATH=src python -m repro_torch.launch.offload_transformer \\
        [--arch falcon-mamba-7b] [--strategy surrogate] [--no-cache] \\
        [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.planner import AutoOffloader, PlannerConfig
from repro_torch.core.strategies import STRATEGY_NAMES
from repro_torch.models.offload_program import make_lm_program

# each region's hopper variant and the hand-written kernel it launches
DEPLOY = {"attn_core": "flash_attention", "ssm_scan": "ssm_scan",
          "rglru_scan": "rglru_scan", "decode_attn": "decode_attention"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="falcon-mamba-7b")
    ap.add_argument("--no-cache", action="store_true",
                    help="always re-measure instead of using the plan cache")
    ap.add_argument("--strategy", default="staged",
                    choices=list(STRATEGY_NAMES),
                    help="Step-4 search strategy (part of the plan-cache "
                         "key); surrogate = roofline-predicted fitness "
                         "(recommended for the large LM-block space), auto "
                         "= pick by space size")
    ap.add_argument("--seed", type=int, default=0,
                    help="strategy RNG seed (GA)")
    ap.add_argument("--tune-tiles", action="store_true",
                    help="search (variant, tile params) genes for variants "
                         "declaring a TuningSpace (attn_core / ssm_scan / "
                         "rglru_scan tiles); part of the plan-cache key")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)
    prog = make_lm_program(args.arch, device=args.device)
    cache = None if args.no_cache else PlanCache.default()
    report = AutoOffloader(PlannerConfig(
        reps=args.reps, strategy=args.strategy, seed=args.seed,
        tune_tiles=args.tune_tiles)).plan(prog, cache=cache)
    print(report.summary())
    print("\nDeploy mapping: a selected hopper variant launches the "
          "hand-written Hopper kernel of its region ("
          + ", ".join(f"{r}->{k}" for r, k in DEPLOY.items())
          + "); mlp_core, mlp_gelu and moe_dispatch deploy their offload "
          "variants (plain PyTorch).")
    return report


if __name__ == "__main__":
    main()
