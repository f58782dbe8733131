"""In/out shardings for every step type on a mesh — the port of the JAX
package's ``launch/shardings.py``.  Each function returns a tree of
:class:`~repro_torch.parallel.rules.NamedSharding` (the spec and its
DTensor placements) shaped like the step's inputs and outputs."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import factory as F
from repro_torch.models import lm
from repro_torch.parallel.rules import (NamedSharding, ParallelismConfig,
                                        batch_shardings, partition_spec,
                                        replicated, tree_shardings)


def param_shardings(cfg: ModelConfig, mesh, pcfg: ParallelismConfig):
    return tree_shardings(lm.model_template(cfg), mesh, pcfg, kind="weight")


def train_state_shardings(cfg: ModelConfig, mesh, pcfg: ParallelismConfig):
    p_sh = param_shardings(cfg, mesh, pcfg)
    rep = replicated(mesh)
    return {"params": p_sh, "opt": {"m": p_sh, "v": p_sh, "count": rep},
            "step": rep}


def cache_shardings(cfg: ModelConfig, mesh, pcfg: ParallelismConfig,
                    batch: int, ctx: int):
    return tree_shardings(lm.cache_template(cfg, batch, ctx), mesh, pcfg,
                          kind="cache")


def logits_sharding(cfg: ModelConfig, mesh, pcfg: ParallelismConfig,
                    batch: int):
    spec = partition_spec((batch, 1, cfg.vocab_size),
                          ("batch", None, "vocab"), mesh, pcfg, kind="act")
    return NamedSharding(mesh, spec)


def metrics_shardings(mesh):
    rep = replicated(mesh)
    return {"loss": rep, "lr": rep, "grad_norm": rep}


def train_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    pcfg: ParallelismConfig):
    state_sh = train_state_shardings(cfg, mesh, pcfg)
    batch_sh = batch_shardings(F.batch_spec(cfg, shape), mesh, pcfg)
    return (state_sh, batch_sh), (state_sh, metrics_shardings(mesh))


def prefill_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      pcfg: ParallelismConfig):
    b, s = shape.global_batch, shape.seq_len
    p_sh = param_shardings(cfg, mesh, pcfg)
    batch_sh = batch_shardings(F.batch_spec(cfg, shape), mesh, pcfg)
    cache_sh = cache_shardings(cfg, mesh, pcfg, b, s + cfg.n_front)
    out = (logits_sharding(cfg, mesh, pcfg, b), cache_sh)
    return (p_sh, batch_sh), out


def serve_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    pcfg: ParallelismConfig):
    b, s = shape.global_batch, shape.seq_len
    p_sh = param_shardings(cfg, mesh, pcfg)
    cache_sh = cache_shardings(cfg, mesh, pcfg, b, s)
    tok_sh = batch_shardings({"tokens": F.meta_tensor((b, 1), torch.int32),
                              "pos": F.meta_tensor((b,), torch.int32)},
                             mesh, pcfg)
    in_sh = (p_sh, cache_sh, tok_sh["tokens"], tok_sh["pos"])
    out_sh = (logits_sharding(cfg, mesh, pcfg, b), cache_sh)
    return in_sh, out_sh


def distribute(tree, shardings):
    """``tree`` laid out by the matching tree of shardings: a plain leaf
    (the same on every rank) becomes a DTensor of which each rank keeps
    its block, a DTensor is redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(distribute(v, sh) for v, sh in zip(tree, shardings))
    if isinstance(tree, DTensor):
        return tree.redistribute(shardings.mesh, shardings.placements)
    return distribute_tensor(tree, shardings.mesh, shardings.placements,
                             src_data_rank=None)
