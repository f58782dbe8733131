"""End-to-end training driver on the port — the twin of
``examples/train_lm.py``: a ~100M-parameter model of the arch's family
trained with the full plumbing (checkpoints, restart, straggler watchdog,
synthetic pipeline) on one device.

    PYTHONPATH=src python -m repro_torch.launch.train_lm [--steps 300] \\
        [--arch qwen2-72b] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import logging

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.device import resolve_device
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.parallel.rules import ParallelismConfig
from repro_torch.runtime.loop import LoopConfig, LoopResult, run_training


def hundred_m_config(arch: str) -> ModelConfig:
    """Scale the arch down to ~100M params, same family (JAX's sizes)."""
    cfg = get_config(arch)
    return dataclasses.replace(
        cfg, name=cfg.name + "-100m",
        num_layers=min(cfg.num_layers, 12),
        d_model=512, num_heads=8,
        num_kv_heads=min(max(cfg.num_kv_heads, 1), 4) if cfg.num_kv_heads else 0,
        head_dim=64, d_ff=2560 if cfg.d_ff else 0, vocab_size=32_000,
        num_experts=min(cfg.num_experts, 8),
        experts_per_token=min(cfg.experts_per_token, 2),
        moe_d_ff=512 if cfg.moe_d_ff else 0,
        dense_residual_d_ff=512 if cfg.dense_residual_d_ff else 0,
        rglru_d_rnn=512 if cfg.rglru_d_rnn else 0,
        attn_window=min(cfg.attn_window, 256) if cfg.attn_window else 0,
        encoder_layers=min(cfg.encoder_layers, 4),
        encoder_seq=min(cfg.encoder_seq, 128) if cfg.encoder_seq else 0,
        frontend_seq=min(cfg.frontend_seq, 64) if cfg.frontend_seq else 0,
        frontend_dim=512 if cfg.frontend_dim else 0,
    )


def main(argv=None) -> LoopResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-72b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="results/ckpt_train_lm")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = hundred_m_config(args.arch)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"active={cfg.active_param_count()/1e6:.1f}M")
    pcfg = ParallelismConfig(tp=True, fsdp=False, remat="none", microbatch=1)
    data = SyntheticLM(cfg, args.batch, args.seq, seed=0)
    ck = CheckpointManager(args.ckpt_dir, keep_n=2)
    lr = functools.partial(cosine_with_warmup, peak_lr=3e-3, warmup_steps=20,
                           total_steps=args.steps)
    res = run_training(cfg, pcfg, dev, data,
                       LoopConfig(total_steps=args.steps, checkpoint_every=100,
                                  log_every=20),
                       ckpt=ck, lr_fn=lr)
    if res.losses:
        print(f"loss: {res.losses[0]:.3f} -> {res.losses[-1]:.3f} over "
              f"{res.final_step} steps ({'resumed from %d' % res.restored_from
                                          if res.restored_from else 'fresh'})")
        print(f"mean step time: "
              f"{1e3 * sum(res.step_times) / len(res.step_times):.0f} ms; "
              f"straggler events: {res.straggler_events}")
    return res


if __name__ == "__main__":
    main()
