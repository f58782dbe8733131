"""Training launcher on the port — the twin of the JAX package's
``launch/train.py``: restore-from-latest, periodic async checkpoints,
SIGTERM flush and the straggler watchdog are live.  A (data, model) mesh
larger than 1x1 runs under ``torchrun``, one rank a mesh device: over
gloo with ``--device cpu``, over NCCL with one card a rank on ``cuda``
(it raises when there are fewer cards than ranks, and never falls back
to the CPU).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mistral-nemo-12b \\
        --reduced --device cpu --steps 20 [--ckpt-dir /tmp/ckpt]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen2-72b --reduced --device cpu --data-mesh 2 --model-mesh 2
"""
from __future__ import annotations

import argparse
import datetime
import functools
import logging
import os

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.device import resolve_device
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.parallel.presets import parallelism_for
from repro_torch.runtime.loop import LoopConfig, LoopResult, run_training

PG_TIMEOUT_S = 300       # a rendezvous or collective that hangs fails here


def init_mesh(dev, data: int, model: int):
    """The (data, model) ``DeviceMesh`` over the ranks ``torchrun`` started:
    gloo for a CPU run, NCCL with one card a rank otherwise."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != data * model:
        raise ValueError(
            f"mesh data={data} x model={model} needs {data * model} ranks; "
            + ("this is one process on one device: start it under torchrun "
               f"--nproc-per-node {data * model}" if world == 1 else
               f"torchrun started {world}"))
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if torch.cuda.device_count() < local:
            raise RuntimeError(f"{local} ranks on this host, "
                               f"{torch.cuda.device_count()} cards: NCCL "
                               "takes one card a rank")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    return make_host_mesh(data, model)


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
    dev = resolve_device(args.device)
    on_mesh = args.data_mesh * args.model_mesh > 1 or int(
        os.environ.get("WORLD_SIZE", "1")) > 1
    mesh = init_mesh(dev, args.data_mesh, args.model_mesh) if on_mesh \
        else dev
    lead = not on_mesh or int(os.environ.get("RANK", "0")) == 0

    logging.basicConfig(level=logging.INFO if lead else logging.WARNING,
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
    res = run_training(cfg, pcfg, mesh, data,
                       LoopConfig(total_steps=args.steps,
                                  checkpoint_every=args.checkpoint_every),
                       ckpt=ckpt, seed=args.seed, lr_fn=lr)
    if lead:
        print(f"final loss {res.losses[-1]:.4f} after {res.final_step} "
              f"steps on {args.data_mesh}x{args.model_mesh}; "
              f"stragglers={res.straggler_events}"
              + (f"; resumed from {res.restored_from}"
                 if res.restored_from else "")
              if res.losses else f"nothing to run: at step {res.final_step}")
    return res


if __name__ == "__main__":
    main()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
