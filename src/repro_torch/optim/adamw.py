"""AdamW with global-norm clipping — the port of the JAX package's
``optim/adamw.py``.  The state mirrors the parameter tree.

Math in float32, moments stored in ``moment_dtype``, decoupled weight
decay on matrices (ndim >= 2) only, as in JAX.  Unlike JAX, :func:`update`
writes the parameters and moments IN PLACE (under ``torch.no_grad()``)
and returns the same tensors: the step's float32 temporaries are taken
over chunks of each flattened leaf, so at full width they stay small
beside the moments (the update is elementwise, so the values are the
same as over the whole leaf).

Under a mesh the leaves are DTensors.  AdamW is elementwise, so each rank
updates its local shards (a gradient is first laid out as its parameter);
:func:`global_norm` sums each rank's local squares and reduces them over
the mesh dims the leaves are sharded on.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.params import DTYPES, tree_leaves, tree_map
from repro_torch.parallel.ctx import local_region

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
    device = tree_leaves(params)[0].device
    return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=dt), params),
            "v": tree_map(lambda p: torch.zeros_like(p, dtype=dt), params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_state(abstract_params, cfg: AdamWConfig):
    """The state of ``abstract_params`` (meta tensors) as meta tensors."""
    dt = DTYPES[cfg.moment_dtype]
    meta = lambda p: torch.empty(p.shape, dtype=dt, device="meta")
    return {"m": tree_map(meta, abstract_params),
            "v": tree_map(meta, abstract_params),
            "count": torch.empty((), dtype=torch.int32, device="meta")}


def _is_dtensor(x) -> bool:
    return hasattr(x, "to_local") and hasattr(x, "placements")


def _local(x):
    return x.to_local() if _is_dtensor(x) else x


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares of every leaf of ``tree``
    (:func:`_norm_of_leaves`)."""
    return _norm_of_leaves(tree_leaves(tree))


def _norm_of_leaves(leaves) -> torch.Tensor:
    """sqrt of the float32 sum of squares of ``leaves`` (summed over
    chunks, so no float32 copy of a whole bf16 leaf is made).  DTensor
    leaves: each rank's local squares, summed over the mesh dims a leaf
    is sharded on, grouped so one reduction serves every leaf of a
    layout."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    groups: dict = {}
    with local_region():
        for x in leaves:
            key = None
            if _is_dtensor(x):
                if any(p.is_partial() for p in x.placements):
                    raise ValueError("global_norm of a partial-sum DTensor")
                key = (x.device_mesh, tuple(p.is_shard()
                                            for p in x.placements))
            for part in _local(x).reshape(-1).split(CHUNK):
                sq = part.float().square().sum()
                groups[key] = groups.get(key, 0.0) + sq
        total = groups.pop(None, 0.0)
        for (mesh, sharded), sq in groups.items():
            pl = [Partial() if s else Replicate() for s in sharded]
            total = total + DTensor.from_local(sq, mesh, pl,
                                               run_check=False).full_tensor()
        return torch.sqrt(torch.as_tensor(total))


@torch.no_grad()
def update(grads, state, params, lr: torch.Tensor, cfg: AdamWConfig):
    """One AdamW step.  Returns (params, state, metrics), the params and
    moments updated in place (under a mesh: each rank its local blocks,
    outside any gather fallback)."""
    with local_region():
        return _update(grads, state, params, lr, cfg)


def _update(grads, state, params, lr, cfg: AdamWConfig):
    flat_p, flat_g = tree_leaves(params), tree_leaves(grads)
    # a gradient laid out as its parameter: the update is then local
    flat_g = [g.redistribute(p.device_mesh, p.placements)
              if _is_dtensor(g) and tuple(g.placements) != tuple(p.placements)
              else g for g, p in zip(flat_g, flat_p)]
    count = state["count"] + 1
    gnorm = _norm_of_leaves(flat_g)
    flat_m, flat_v = tree_leaves(state["m"]), tree_leaves(state["v"])
    lr, count_l = _local(lr), _local(count)
    scale = torch.clamp_max(cfg.clip_norm / (gnorm + 1e-9), 1.0)
    b1c = 1 - cfg.b1 ** count_l.float()
    b2c = 1 - cfg.b2 ** count_l.float()
    for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p):
        decay = p.dim() >= 2                  # decoupled wd on matrices only
        g, m, v, p = _local(g), _local(m), _local(v), _local(p)
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
