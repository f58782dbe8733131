"""Mixture-of-Experts FFN with two dispatch strategies — the port of the JAX
package's ``models/moe.py``.

* ``token_onehot`` (``moe_ffn`` ``ref``) — GShard-style token-choice top-k,
  capacity-bounded, routed through the ``moe_dispatch`` region: a one-hot
  dispatch tensor [T, E, C] (``ref``) or scatter slots (``offload``).
* ``expert_choice`` (``moe_ffn`` ``offload``) — group-local expert-choice
  top-C: each expert picks its C best tokens within each group.  The
  default for every MoE config, as in the JAX package.

Precision and order follow the JAX code:

* the router logits are a float32 product of the bf16-rounded tokens and
  the router weight (JAX: ``preferred_element_type=float32``), never a
  bf16 product, whose rounding would flip top-k choices;
* top-k breaks ties toward the lower index, as ``jax.lax.top_k`` does:
  a stable descending sort, whose leading k columns are taken
  (``torch.topk`` makes no such promise, and on the CPU picks otherwise);
* a one-hot is a comparison with ``arange`` (``jax.nn.one_hot`` gives a
  zero row out of range, where ``F.one_hot`` raises after a host sync);
* the expert-choice combine adds each expert's outputs in expert order,
  one expert at a time (a token appears at most once per expert, so no
  two adds of one scatter-add meet), so it is deterministic on a card,
  where one scatter-add over all experts is not, and rounds to the
  activations' type after each add, as JAX's scatter-add.  The scatter-add
  is in place and needs no earlier value of the output for its backward,
  so the combine back-propagates.

Nothing here reads a value back to the host: capacities and group counts
are Python ints from static shapes, so a prefill or decode step with MoE
layers captures into a CUDA graph.

:class:`ExpertChoiceLog` records each expert-choice layer's router logits
and picks, and can replay the picks of one run in another (the MoE
prefill check of ``models/moe_check.py``).  It acts only inside ``with
log.active():`` on the thread that entered it; elsewhere the routing runs
exactly as without it and adds no operation to a captured graph.  The
expert-choice dispatch carries JAX's sharding constraints
(``parallel.ctx.constrain``: groups over the data axes, experts over the
model axis, a group-local combine); they are the identity on one device.
:func:`aux_load_balance_loss` is
the Switch-style auxiliary loss; as in the JAX package no loss function
calls it.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F

from repro_torch.core.regions import dispatch, register_variant
from repro_torch.parallel import ctx as PC
from repro_torch.parallel.ctx import constrain


def _router_logits(x: torch.Tensor, w_router: torch.Tensor) -> torch.Tensor:
    """[..., D] x [D, E] -> float32 [..., E] from the bf16-rounded tokens
    (exact products, float32 sums; TF32 must be off on a card)."""
    return x.to(torch.bfloat16).float() @ w_router.float()


def router_probs(x: torch.Tensor, w_router: torch.Tensor) -> torch.Tensor:
    """x: [T, D] -> probs [T, E] (float32 softmax)."""
    return torch.softmax(_router_logits(x, w_router), dim=-1)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries along the last axis and their indices, in
    descending order, ties to the lower index (``jax.lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a zero row where ``idx`` is out of [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _expert_ffn(xe: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """xe: [E, C, D]; weights: [E, D, F] / [E, F, D] -> [E, C, D]."""
    h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    return torch.bmm(h, w_down)


def moe_capacity(n_tokens: int, num_experts: int, k: int,
                 capacity_factor: float) -> int:
    c = int(math.ceil(n_tokens * k * capacity_factor / num_experts))
    return max(8, -(-c // 8) * 8)      # rounded up to 8, as in the JAX code


def route_tokens(x, w_router, num_experts: int, k: int, capacity: int):
    """Token-choice routing shared by both ``moe_dispatch`` variants:
    (normalized gate values [T, k], expert ids [T, k], one-hot [T, k, E],
    queue positions [T, k], kept [T, k])."""
    t = x.shape[0]
    probs = router_probs(x, w_router)                         # [T, E]
    gate_vals, gate_idx = top_k(probs, k)                     # [T, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # position of each (token, choice) within its expert queue
    onehot = _one_hot(gate_idx, num_experts, torch.int32)     # [T, k, E]
    flat = onehot.reshape(t * k, num_experts)
    pos = torch.cumsum(flat, dim=0) - flat                    # [T*k, E]
    pos_in_expert = (pos * flat).sum(-1).reshape(t, k)        # [T, k]
    keep = pos_in_expert < capacity
    return gate_vals, gate_idx, onehot, pos_in_expert, keep


_ACTIVE = threading.local()      # .log: the ExpertChoiceLog in use, if any


class ExpertChoiceLog:
    """The expert-choice layers of one run, in the order they route:
    ``logits`` (the router's float32 scores [G, T/G, E]) and ``picks`` (the
    tokens each expert took, ``idx`` [G, E, C]).

    Given ``replay`` (the ``picks`` of another run on the same shapes),
    layer i combines the tokens ``replay[i]`` instead of its own top-C, at
    the gates of its own router probabilities at those tokens; ``picks``
    then records what it combined.  The log is recorded only inside
    :meth:`active`."""

    def __init__(self, replay: list | None = None):
        self.replay = replay
        self.logits: list = []
        self.picks: list = []

    @contextlib.contextmanager
    def active(self):
        prev = getattr(_ACTIVE, "log", None)
        _ACTIVE.log = self
        try:
            yield self
        finally:
            _ACTIVE.log = prev

    def route(self, logits, probs, gate, idx):
        """(gate, idx) for the layer that routed ``logits``."""
        if self.replay is not None:
            idx = self.replay[len(self.picks)]
            gate = probs.transpose(1, 2).gather(-1, idx)
        self.logits.append(logits)
        self.picks.append(idx)
        return gate, idx


@register_variant("moe_dispatch", "ref")
def moe_dispatch_dense(x, w_router, w_gate, w_up, w_down, *, num_experts: int,
                       k: int, capacity: int):
    """Capacity-bounded token-choice top-k with one-hot dispatch.  x: [T, D].

    The flat-argument, static-capacity form of the GShard dense dispatch:
    the routing is bounded by the Python-int ``capacity``, which is what
    makes the block legal for static offload (the extractor's
    ``moe_dispatch`` recognizer keys on this bound)."""
    c = int(capacity)
    gate_vals, _, onehot, pos_in_expert, keep = route_tokens(
        x, w_router, num_experts, k, c)
    # dispatch tensor [T, k, E, C]; a dropped token's row is zero
    disp = (onehot.to(x.dtype)[..., None]
            * _one_hot(pos_in_expert, c, x.dtype)[:, :, None, :]
            * keep[:, :, None, None].to(x.dtype))
    combine = disp * gate_vals[:, :, None, None].to(x.dtype)
    disp = disp.sum(1)                                        # [T, E, C]
    combine = combine.sum(1)                                  # [T, E, C]
    xe = torch.einsum("td,tec->ecd", x, disp)                 # [E, C, D]
    ye = _expert_ffn(xe, w_gate, w_up, w_down)
    return torch.einsum("ecd,tec->td", ye, combine).to(x.dtype)


@register_variant("moe_dispatch", "offload")
def moe_dispatch_slots(x, w_router, w_gate, w_up, w_down, *, num_experts: int,
                       k: int, capacity: int):
    """Scatter-slot dispatch: token t's choice j lands at flat slot
    ``gate_idx * capacity + pos_in_expert`` (dropped tokens at a dead row),
    so the O(T*E*C) one-hot tensor never materializes.  Each live slot
    receives one token, so the scatter-add is exact: the semantics of
    ``ref``."""
    t, d = x.shape
    c = int(capacity)
    gate_vals, gate_idx, _, pos_in_expert, keep = route_tokens(
        x, w_router, num_experts, k, c)
    slot = torch.where(keep, gate_idx * c + pos_in_expert,
                       num_experts * c).reshape(t * k)        # dead row E*c
    src = x[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = x.new_zeros((num_experts * c + 1, d)).index_add_(0, slot, src)
    xe = buf[:-1].reshape(num_experts, c, d)                  # [E, C, D]
    ye = _expert_ffn(xe, w_gate, w_up, w_down)
    ye_pad = torch.cat([ye.reshape(num_experts * c, d),
                        ye.new_zeros((1, d))])
    y_tok = ye_pad[slot].reshape(t, k, d)                     # dropped -> 0
    gates = (gate_vals * keep.to(gate_vals.dtype)).to(y_tok.dtype)
    return (y_tok * gates[:, :, None]).sum(1).to(x.dtype)


@register_variant("moe_ffn", "ref")
def moe_token_onehot(x, params, *, num_experts: int, k: int,
                     capacity_factor: float, inner_impl=None):
    """Token-choice top-k with one-hot dispatch.  x: [T, D].

    Routes the capacity-bounded dispatch through the ``moe_dispatch``
    region, so an offload pattern can re-route the routed block itself
    (dense one-hot or scatter slots) within the token-choice strategy."""
    c = moe_capacity(x.shape[0], num_experts, k, capacity_factor)
    return dispatch("moe_dispatch", inner_impl, x, params["router"],
                    params["w_gate"], params["w_up"], params["w_down"],
                    num_experts=num_experts, k=k, capacity=c)


@register_variant("moe_ffn", "offload")
def moe_expert_choice(x, params, *, num_experts: int, k: int,
                      capacity_factor: float, group_size: int = 4096,
                      inner_impl=None):
    """Group-local expert-choice routing.  x: [T, D].

    Tokens are split into groups of <= group_size; each expert picks its
    top-C tokens within each group.  A token may be picked by several
    experts or by none (then its output is 0)."""
    t, d = x.shape
    g = max(1, t // group_size)
    while t % g:                    # a power-of-two t never enters the loop
        g -= 1
    tg = t // g
    e = num_experts
    xg = constrain(x.reshape(g, tg, d), ("batch", None, None))
    logits = _router_logits(xg, params["router"])
    probs = constrain(torch.softmax(logits, dim=-1), ("batch", None, None))
    c = min(moe_capacity(tg, e, k, capacity_factor), tg)
    gate, idx = top_k(probs.transpose(1, 2), c)               # [G, E, C]
    log = getattr(_ACTIVE, "log", None)
    if log is not None:
        gate, idx = log.route(logits, probs, gate, idx)
    flat_idx = idx.reshape(g, e * c)
    xe = torch.gather(xg, 1, flat_idx[..., None].expand(g, e * c, d))
    # G -> data, E -> model (EP)
    xe = constrain(xe.reshape(g, e, c, d), ("batch", "experts", None, None))
    # the experts' products batched over E, G x C rows each
    xe = xe.transpose(0, 1).reshape(e, g * c, d)
    ye = _expert_ffn(xe, params["w_gate"], params["w_up"], params["w_down"])
    ye = ye.reshape(e, g, c, d).transpose(0, 1)               # [G, E, C, D]
    ye = (ye * gate[..., None].to(ye.dtype)).to(x.dtype)
    # under a mesh each group's experts are gathered to it (G -> data),
    # and the combine stays group-local
    ye = constrain(ye, ("batch", None, None, None))
    idx = constrain(idx, ("batch", None, None))
    if hasattr(ye, "device_mesh"):
        return _combine_local(ye, idx, (g, tg, d)).reshape(t, d)
    return _combine(ye, idx, x.new_zeros((g, tg, d)))


def _combine(ye, idx, out):
    """Add each expert's outputs ye [G, E, C, D] at its tokens idx
    [G, E, C] into out [G, Tg, D], in expert order: the tokens of one
    expert are distinct, so each scatter-add has no collisions."""
    g, e, c, d = ye.shape
    for j in range(e):
        out.scatter_add_(1, idx[:, j, :, None].expand(g, c, d), ye[:, j])
    return out.reshape(-1, d)


def _combine_local(ye, idx, shape):
    """:func:`_combine` of DTensors laid out by groups (dim 0 over the data
    axes, whole elsewhere): each rank combines its own groups, the blocks
    making the [G, Tg, D] DTensor of the same layout (DTensor has no
    sharded scatter-add)."""
    from torch.distributed.tensor import DTensor

    mesh, pl = ye.device_mesh, tuple(ye.placements)
    yl = ye.to_local()
    block = (yl.shape[0],) + tuple(shape[1:])
    with PC.local_region():
        out = _combine(yl, idx.to_local(), yl.new_zeros(block)).reshape(block)
    return DTensor.from_local(out, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=(shape[1] * shape[2], shape[2], 1))


def aux_load_balance_loss(probs: torch.Tensor, gate_idx: torch.Tensor,
                          num_experts: int) -> torch.Tensor:
    """Switch-style auxiliary load-balancing loss (fraction * prob): probs
    [T, E], gate_idx [T, k] (the first choice counts)."""
    me = probs.float().mean(dim=0)                             # [E]
    ce = _one_hot(gate_idx[:, 0], num_experts, torch.float32).mean(dim=0)
    return num_experts * torch.sum(me * ce)
