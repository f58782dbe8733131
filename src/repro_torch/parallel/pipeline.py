"""Pipeline parallelism over a mesh axis (GPipe schedule, forward path) —
the port of the JAX package's ``parallel/pipeline.py``.

The stacked layer dim is split over the pipeline axis, so stage s holds
layers [s*L/S, (s+1)*L/S).  Every rank of the axis runs the same program;
its stage is its coordinate on the axis, and activations move one stage a
tick by point-to-point sends around the axis's ring
(``batch_isend_irecv``; JAX: ``lax.ppermute``).  Fill-drain (GPipe)
schedule: with M microbatches and S stages, T = M + S - 1 ticks, bubble
fraction (S-1)/(M+S-1).  The last stage's outputs reach every rank by a
masked all-reduce, as in JAX (a one-to-many permutation is not a
bijection).

Scope, as in JAX: forward/inference pipelining.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.params import tree_leaves, tree_map


def _local_stack(tree, sid: int, n_stages: int):
    """This stage's layers: a DTensor leaf's local block (sharded on its
    leading dim over the axis), or the stage's slice of a whole stack."""
    def one(p):
        if hasattr(p, "to_local"):
            return p.to_local()
        per = p.shape[0] // n_stages
        return p[sid * per:(sid + 1) * per]
    return tree_map(one, tree)


def pipeline_apply(stage_stack_params, x, *, unit_body: Callable, mesh,
                   axis: str = "pod", microbatches: int = 2):
    """Run ``unit_body`` over a layer stack pipelined across ``axis`` of
    ``mesh`` (a ``DeviceMesh``).

    stage_stack_params: tree with leading layer dim L: DTensors sharded on
        dim 0 over ``axis``, or whole stacks (each stage takes its L/S).
    x: [B, ...] activations, the same on every rank of the axis;
        B % microbatches == 0.
    unit_body: (carry_x, unit_params) -> carry_x, applied per local layer.
    Returns y [B, ...] (the last stage's, on every rank)."""
    import torch.distributed as dist

    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    group = mesh.get_group(axis)
    sid = mesh.get_local_rank(axis)
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    b = x.shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} is not a multiple of {microbatches} "
                         "microbatches")
    mb = b // microbatches
    local = _local_stack(stage_stack_params, sid, n_stages)
    n_local = tree_leaves(local)[0].shape[0]

    def run_stage(act):
        for i in range(n_local):
            act = unit_body(act, tree_map(lambda p: p[i], local))
        return act

    ticks = microbatches + n_stages - 1
    x_mb = x.reshape((microbatches, mb) + tuple(x.shape[1:]))
    inflight = torch.zeros_like(x_mb[0])
    outputs = torch.zeros_like(x_mb)
    nxt = dist.get_global_rank(group, (sid + 1) % n_stages)
    prv = dist.get_global_rank(group, (sid - 1) % n_stages)
    for t in range(ticks):
        # stage 0 injects microbatch t (if any remain); others use inflight
        my_in = x_mb[min(t, microbatches - 1)] if sid == 0 else inflight
        # live iff this stage has work at tick t: sid <= t < sid + M
        live = sid <= t < sid + microbatches
        my_out = run_stage(my_in) if live else my_in
        if live and sid == n_stages - 1:        # the last stage banks it
            outputs[t - (n_stages - 1)] = my_out
        if n_stages > 1:                        # shift to the next stage
            recv = torch.empty_like(my_out)
            ops = [dist.P2POp(dist.isend, my_out.contiguous(), nxt, group),
                   dist.P2POp(dist.irecv, recv, prv, group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            inflight = recv
    if sid != n_stages - 1:
        outputs.zero_()
    dist.all_reduce(outputs, op=dist.ReduceOp.SUM, group=group)
    return outputs.reshape((b,) + tuple(x.shape[1:]))
