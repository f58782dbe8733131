"""Training loop with the fault-tolerance envelope — the port of the JAX
package's ``runtime/loop.py``:

* restore-from-latest on start (crash/preemption recovery), the data
  iterator's position included
* periodic async checkpoints, a SIGTERM flush (the handler it replaced is
  put back when the loop ends) and a final save
* straggler watchdog: an EWMA of the step's wall time on the host clock,
  read after the loss's ``.item()`` has synchronized with the device; a
  step slower than ``straggler_factor`` x the EWMA is logged and counted
* the loss and step-time history for the harness

The signature is JAX's with the PRNG key replaced by a seed.  Where JAX
takes a mesh, :func:`run_training` takes a ``DeviceMesh`` or a device
(None = ``cuda``; a CPU run asks for ``"cpu"``).  On a mesh the state is
laid out by ``launch/shardings.py`` (every rank draws the same parameters
from the seed and keeps its block, or restores its block of a checkpoint
of any layout), each batch by ``data.pipeline.shard_batch``, and every
step runs under ``parallel_context``.
"""
from __future__ import annotations

import collections
import contextlib
import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.regions import Impl
from repro_torch.data.pipeline import shard_batch, to_device
from repro_torch.launch import shardings as SH
from repro_torch.parallel.ctx import parallel_context
from repro_torch.parallel.rules import ParallelismConfig
from repro_torch.runtime import steps as RS

log = logging.getLogger("repro_torch.runtime")


@dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2


@dataclass
class LoopResult:
    losses: list = field(default_factory=list)
    grad_norms: list = field(default_factory=list)
    # on a mesh: the calls the parallel context gathered (parallel/ctx.py)
    gathered: collections.Counter = field(default_factory=collections.Counter)
    step_times: list = field(default_factory=list)
    straggler_events: int = 0
    restored_from: Optional[int] = None
    final_step: int = 0


def _data_extra(data_iter) -> dict:
    return ({"data": data_iter.state_dict()}
            if hasattr(data_iter, "state_dict") else {})


def _scalar(x) -> float:
    """A 0-d metric as a float (synchronizes)."""
    return (x.full_tensor() if hasattr(x, "full_tensor") else x).item()


def run_training(cfg: ModelConfig, pcfg: ParallelismConfig, mesh,
                 data_iter, loop_cfg: LoopConfig = LoopConfig(),
                 ckpt: Optional[CheckpointManager] = None, seed: int = 0,
                 lr_fn: Optional[Callable] = None,
                 impl: Optional[Impl] = None) -> LoopResult:
    """Train ``cfg`` from parameters drawn with ``seed`` (or the latest
    checkpoint of ``ckpt``) up to ``loop_cfg.total_steps`` on ``mesh``, a
    ``DeviceMesh`` or a device; ``data_iter`` yields host batches
    (``data/pipeline.py``)."""
    on_mesh = hasattr(mesh, "mesh_dim_names")
    if on_mesh:
        dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device("cpu")
        state_sh = SH.train_state_shardings(cfg, mesh, pcfg)
        step_ctx = lambda: parallel_context(mesh, pcfg)
        put = lambda b: shard_batch(b, mesh, pcfg)
    else:
        dev = resolve_device(mesh)
        state_sh = None
        step_ctx = contextlib.nullcontext
        put = lambda b: to_device(b, dev)
    result = LoopResult()
    step_fn = RS.make_train_step(cfg, pcfg, lr_fn=lr_fn, impl=impl)
    state = RS.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(seed))
    if on_mesh:
        state = SH.distribute(state, state_sh)
    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        state, meta = ckpt.restore(state, shardings=state_sh)
        start_step = int(meta["step"])
        result.restored_from = result.final_step = start_step
        if hasattr(data_iter, "load_state_dict") and "data" in meta.get(
                "extra", {}):
            data_iter.load_state_dict(meta["extra"]["data"])
        log.info("restored from step %d", start_step)

    latest = {"step": start_step, "state": state}
    if ckpt is not None:
        ckpt.install_sigterm_handler(lambda: (latest["step"], latest["state"]))
    try:
        ewma = None
        for step in range(start_step, loop_cfg.total_steps):
            batch = put(next(data_iter))
            t0 = time.perf_counter()
            with step_ctx() as pc:
                state, metrics = step_fn(state, batch)
            if pc is not None:
                result.gathered.update(pc.gathered)
            loss = _scalar(metrics["loss"])        # synchronizes
            dt = time.perf_counter() - t0
            result.losses.append(loss)
            result.grad_norms.append(_scalar(metrics["grad_norm"]))
            result.step_times.append(dt)
            if ewma is None:
                ewma = dt
            else:
                if dt > loop_cfg.straggler_factor * ewma:
                    result.straggler_events += 1
                    log.warning("straggler step %d: %.3fs vs ewma %.3fs",
                                step, dt, ewma)
                a = loop_cfg.ewma_alpha
                ewma = (1 - a) * ewma + a * dt
            latest = {"step": step + 1, "state": state}
            if loop_cfg.log_every and step % loop_cfg.log_every == 0:
                log.info("step %d loss %.4f (%.0f ms)", step, loss, dt * 1e3)
            if (ckpt is not None and loop_cfg.checkpoint_every
                    and (step + 1) % loop_cfg.checkpoint_every == 0):
                ckpt.save_async(step + 1, state, extra=_data_extra(data_iter))
            result.final_step = step + 1

        if ckpt is not None:
            ckpt.wait()
            ckpt.save(result.final_step, state, extra=_data_extra(data_iter))
    finally:
        if ckpt is not None:
            ckpt.restore_sigterm_handler()
    return result
