"""AdamW with global-norm clipping — the port of the JAX package's
``optim/adamw.py``.  The state mirrors the parameter tree.

Math in float32, moments stored in ``moment_dtype``, decoupled weight
decay on matrices (ndim >= 2) only, as in JAX.  Unlike JAX, :func:`update`
writes the parameters and moments IN PLACE (under ``torch.no_grad()``)
and returns the same tensors: the step's float32 temporaries are taken
over chunks of each flattened leaf, so at full width they stay small
beside the moments (the update is elementwise, so the values are the
same as over the whole leaf).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.params import DTYPES, tree_leaves, tree_map

CHUNK = 1 << 24                   # elements of a leaf updated at a time


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


def init_state(params, cfg: AdamWConfig):
    dt = DTYPES[cfg.moment_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares of every leaf (summed over
    chunks, so no float32 copy of a whole bf16 leaf is made)."""
    sq = sum(part.float().square().sum()
             for x in tree_leaves(tree) for part in x.reshape(-1).split(CHUNK))
    return torch.sqrt(sq)


@torch.no_grad()
def update(grads, state, params, lr: torch.Tensor, cfg: AdamWConfig):
    """One AdamW step.  Returns (params, state, metrics), the params and
    moments updated in place."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / (gnorm + 1e-9), 1.0)
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()
    flat_p, flat_g = tree_leaves(params), tree_leaves(grads)
    flat_m, flat_v = tree_leaves(state["m"]), tree_leaves(state["v"])
    for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p):
        decay = p.dim() >= 2                  # decoupled wd on matrices only
        # view(-1): p, m and v are written in place, so must be contiguous
        parts = zip(g.reshape(-1).split(CHUNK), m.view(-1).split(CHUNK),
                    v.view(-1).split(CHUNK), p.view(-1).split(CHUNK))
        for gc, mc, vc, pc in parts:
            gc = gc.float() * scale
            m_new = cfg.b1 * mc.float() + (1 - cfg.b1) * gc
            v_new = cfg.b2 * vc.float() + (1 - cfg.b2) * gc * gc
            m_hat = m_new / b1c
            v_hat = v_new / b2c
            step = m_hat / (torch.sqrt(v_hat) + cfg.eps)
            if decay:
                step = step + cfg.weight_decay * pc.float()
            pc.copy_(pc.float() - lr * step)
            mc.copy_(m_new)
            vc.copy_(v_new)
    return params, {"m": state["m"], "v": state["v"], "count": count}, {
        "grad_norm": gnorm}
