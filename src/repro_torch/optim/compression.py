"""Gradient compression for cross-pod data parallelism — the port of the
JAX package's ``optim/compression.py``.

int8 uniform quantization with a per-tensor scale and **error feedback**
(the quantization residual is carried into the next step, which restores
asymptotic convergence — Seide et al. / Karimireddy et al.).  Intended for
the slow inter-node axis: 4x fewer bytes on the wire for the grad
reduction, at the cost of one float32 pass per tensor.

:func:`compressed_psum` reduces over one process group (JAX: inside
``shard_map`` over a mesh axis; here the group of one ``DeviceMesh``
dim, ``mesh.get_group(axis)``): the int8 payload is summed as int32, and
the scale is all-reduced with MAX, as JAX's ``psum``/``pmax``.  The
quantize/dequantize pieces are plain tensor functions.  Rounding is half
to even (``torch.round``), as ``jnp.round``.
"""
from __future__ import annotations

import torch

from repro_torch.models.params import tree_leaves, tree_map


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8.  Returns (q, scale)."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(grad: torch.Tensor, error: torch.Tensor):
    """Returns (quantized, scale, new_error)."""
    corrected = grad.float() + error
    q, scale = quantize_int8(corrected)
    new_error = corrected - dequantize_int8(q, scale)
    return q, scale, new_error


def compressed_psum(grad: torch.Tensor, error: torch.Tensor, group=None):
    """int8 all-reduce with error feedback over ``group`` (default: the
    whole process group).  The int8 payload is summed as int32; the scales
    are all-reduced with MAX and the sum is dequantized by the largest —
    conservative and correct for symmetric quantization of sums.  Returns
    (float32 sum, new_error)."""
    import torch.distributed as dist

    q, scale, new_error = compress_with_feedback(grad, error)
    q_sum = q.to(torch.int32)
    dist.all_reduce(q_sum, op=dist.ReduceOp.SUM, group=group)
    scale_max = scale.clone()
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    return q_sum.float() * scale_max, new_error


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def tree_compressed_psum(grads, errors, group=None):
    """:func:`compressed_psum` of every leaf; each sum back in its
    gradient's type."""
    flat_e = iter(tree_leaves(errors))
    out_e: list = []

    def one(g):
        s, ne = compressed_psum(g, next(flat_e), group)
        out_e.append(ne)
        return s.to(g.dtype)

    out_g = tree_map(one, grads)
    it = iter(out_e)
    return out_g, tree_map(lambda _: next(it), errors)
