"""Training launcher on the port — the twin of the JAX package's
``launch/train.py`` on one device: restore-from-latest, periodic async
checkpoints, SIGTERM flush and the straggler watchdog are live.  Mesh
sizes above 1 raise (sharding comes with the multi-device slice).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mistral-nemo-12b \\
        --reduced --device cpu --steps 20 [--ckpt-dir /tmp/ckpt]
"""
from __future__ import annotations

import argparse
import functools
import logging

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.device import resolve_device
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.parallel.presets import parallelism_for
from repro_torch.parallel.rules import check_one_device
from repro_torch.runtime.loop import LoopConfig, LoopResult, run_training


def main(argv=None) -> LoopResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config (for the CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--peak-lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)
    check_one_device(data=args.data_mesh, model=args.model_mesh)
    dev = resolve_device(args.device)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    pcfg = parallelism_for(cfg, SHAPES["train_4k"], model_axis=args.model_mesh)
    data = SyntheticLM(cfg, args.batch, args.seq, seed=args.seed)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    lr = functools.partial(cosine_with_warmup, peak_lr=args.peak_lr,
                           warmup_steps=max(args.steps // 10, 1),
                           total_steps=args.steps)
    res = run_training(cfg, pcfg, dev, data,
                       LoopConfig(total_steps=args.steps,
                                  checkpoint_every=args.checkpoint_every),
                       ckpt=ckpt, seed=args.seed, lr_fn=lr)
    print(f"final loss {res.losses[-1]:.4f} after {res.final_step} steps; "
          f"stragglers={res.straggler_events}"
          + (f"; resumed from {res.restored_from}" if res.restored_from else "")
          if res.losses else f"nothing to run: at step {res.final_step}")
    return res


if __name__ == "__main__":
    main()
