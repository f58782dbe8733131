"""Step builders — the port of the JAX package's ``runtime/steps.py``:
``train_step`` (with gradient-accumulation microbatching), the prefill
and serve steps as thin aliases of the factory's, and the dry-run's
:func:`abstract_train_state`.  Under a ``parallel_context`` the state's
leaves are DTensors and the step runs on them unchanged.

The train state is ``{'params', 'opt', 'step'}``, as in JAX.  The step
differentiates the loss with ``torch.autograd.grad`` over detached copies
of the parameters (the state's tensors never require grad, so a served or
checkpointed state holds no autograd history), then updates the
parameters and moments in place (``optim/adamw.py``) and returns the same
state with its counter advanced: the torch counterpart of JAX's donated
state.  The loss runs under ``impl`` (default ``factory.default_impl``,
all of whose regions have a backward); a ``hopper`` kernel refuses an
input that requires grad.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.regions import Impl
from repro_torch.models import factory as F
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.parallel.rules import ParallelismConfig


def _unflatten(like, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def make_train_step(cfg: ModelConfig, pcfg: ParallelismConfig,
                    opt_cfg: Optional[adamw.AdamWConfig] = None,
                    lr_fn: Optional[Callable] = None,
                    impl: Optional[Impl] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    holds tensors on the state's device."""
    opt_cfg = opt_cfg or adamw.AdamWConfig(moment_dtype=pcfg.opt_dtype)
    lr_fn = lr_fn or partial(cosine_with_warmup, peak_lr=3e-4,
                             warmup_steps=100, total_steps=10_000)
    loss_fn = F.make_loss(cfg, impl=impl, remat=pcfg.remat)
    k = pcfg.microbatch

    def grad_fn(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        return loss.detach(), grads

    def accum_grads(params, batch):
        if k <= 1:
            return grad_fn(params, batch)
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
        g_sum = [torch.zeros_like(p, dtype=torch.float32)
                 for p in tree_leaves(params)]
        for j in range(k):
            mb = {key: x.reshape((k, x.shape[0] // k) + x.shape[1:])[j]
                  for key, x in batch.items()}
            loss, g = grad_fn(params, mb)
            loss_sum += loss
            for acc, gi in zip(g_sum, g):
                acc += gi.float()
        grads = [(acc / k).to(p.dtype)
                 for acc, p in zip(g_sum, tree_leaves(params))]
        return loss_sum / k, grads

    def train_step(state, batch):
        loss, grads = accum_grads(state["params"], batch)
        lr = lr_fn(state["step"])
        params, opt, om = adamw.update(_unflatten(state["params"], grads),
                                       state["opt"], state["params"], lr,
                                       opt_cfg)
        new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
        metrics = {"loss": loss.float(), "lr": lr, **om}
        return new_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, impl: Optional[Impl] = None,
                      ctx: Optional[int] = None):
    return F.make_prefill_step(cfg, impl=impl, ctx=ctx)


def make_serve_step(cfg: ModelConfig, impl: Optional[Impl] = None):
    return F.make_serve_step(cfg, impl=impl)


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     opt_cfg: Optional[adamw.AdamWConfig] = None):
    """Parameters drawn from ``generator`` (on its device), zero moments,
    step 0."""
    params = F.init_params(cfg, generator)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    return {"params": params, "opt": adamw.init_state(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32,
                                device=generator.device)}


def abstract_train_state(cfg: ModelConfig,
                         opt_cfg: Optional[adamw.AdamWConfig] = None):
    """The train state as meta tensors (the dry-run's stand-in)."""
    ap = F.abstract_params(cfg)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    return {"params": ap, "opt": adamw.abstract_state(ap, opt_cfg),
            "step": torch.empty((), dtype=torch.int32, device="meta")}
