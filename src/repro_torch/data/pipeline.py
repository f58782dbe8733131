"""Deterministic synthetic LM data — the port of the JAX package's
``data/pipeline.py``: a seeded, stateful, *checkpointable* iterator of
token batches with a bigram structure, so the cross-entropy of a training
run demonstrably falls.

The bigram table comes from ``np.random.default_rng(seed)`` as in JAX, so
the two packages' tables are equal.  JAX draws each step's batch from
``jax.random`` (threefry), which cannot be reproduced without JAX: here
the step's draws come from ``np.random.default_rng(seed * 1_000_003 +
step)``, the same recipe (80% bigram-following tokens, 20% uniform noise,
a uniform first token; standard-normal frontend stubs) from another
stream.  The batches are NumPy host arrays, as ``factory.synthetic_batch``
gives; :func:`to_device` puts one on one device, :func:`shard_batch`
distributes one over a mesh (dim 0 over the data axes).  Frontend stubs
are float32 holding bf16 values (NumPy has no bf16; the models cast on the
device).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.factory import bf16_values, frontend_key


@dataclass
class DataState:
    """Checkpointable pipeline position."""
    seed: int
    step: int


class SyntheticLM:
    """Yields ``{'tokens': int32 [B, S]}`` (+ frontend stubs)
    deterministically: the stream for a given (seed, step) is the same
    across restarts."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.state = DataState(seed=seed, step=0)
        # fixed bigram structure so the loss has something to learn
        rng = np.random.default_rng(seed)
        v = min(cfg.vocab_size, 512)
        self._v = v
        self._next_tok = rng.integers(0, v, size=v).astype(np.int32)

    def _batch_for(self, step: int) -> dict:
        rng = np.random.default_rng(self.state.seed * 1_000_003 + step)
        b, s = self.batch, self.seq
        start = rng.integers(0, self._v, (b,), dtype=np.int32)
        noise = rng.integers(0, self._v, (b, s), dtype=np.int32)
        use_noise = rng.random((b, s)) < 0.2
        tokens = np.empty((b, s + 1), np.int32)
        tokens[:, 0] = start
        for t in range(s):                 # JAX: a scan over the positions
            tokens[:, t + 1] = np.where(use_noise[:, t], noise[:, t],
                                        self._next_tok[tokens[:, t]])
        out = {"tokens": tokens[:, :s]}
        key = frontend_key(self.cfg)
        if key is not None:
            out[key] = bf16_values(rng.standard_normal(
                (b, self.cfg.frontend_seq, self.cfg.frontend_dim),
                dtype=np.float32))
        return out

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = self._batch_for(self.state.step)
        self.state.step += 1
        return b

    # -- checkpoint integration -----------------------------------------
    def state_dict(self) -> dict:
        return {"seed": self.state.seed, "step": self.state.step}

    def load_state_dict(self, d: dict) -> None:
        self.state = DataState(seed=int(d["seed"]), step=int(d["step"]))


def to_device(batch: dict, device) -> dict:
    """A host batch as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def shard_batch(batch: dict, mesh, pcfg) -> dict:
    """A host batch as DTensors over ``mesh`` with the standard batch
    shardings (every rank holds the same host batch; each keeps its
    block)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.parallel.rules import batch_shardings

    shardings = batch_shardings(batch, mesh, pcfg)
    dev = mesh.device_type
    return {k: distribute_tensor(torch.as_tensor(v).to(dev), mesh,
                                 shardings[k].placements,
                                 src_data_rank=None)
            for k, v in batch.items()}
