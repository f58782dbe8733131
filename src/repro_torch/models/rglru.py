"""RG-LRU recurrent block (Griffin / recurrentgemma) — the port of the JAX
package's ``models/rglru.py``.

Recurrence (per channel, diagonal):
    r_t = sigmoid(block_diag(W_a) x_t)            # recurrence gate
    i_t = sigmoid(block_diag(W_x) x_t)            # input gate
    a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Block structure (Griffin recurrent block): in-proj to (branch, gate),
causal depthwise conv(4) on the branch, RG-LRU, GeLU(gate) multiply,
out-proj.  The scan is the offloadable region ``rglru_scan``: ``ref`` runs
the chunked associative scan (chunks of 512), ``offload`` the same in
float32 with chunks of 2,048, and the ``hopper`` variant
(``kernels/ops.py``) the CUDA kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.loops import fori_loop
from repro_torch.core.regions import dispatch, register_variant
from repro_torch.models.ssm import (associative_scan, causal_depthwise_conv,
                                   pad_time)

RGLRU_C = 8.0


@register_variant("rglru_scan", "ref")
def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                   chunk: int = 512):
    """a, b: [B, S, D]; h0: [B, D].  Returns (h_all [B, S, D], h_final).
    As in JAX, the carry keeps h0's type (float32) and so does h_all."""
    bsz, s, d = a.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    a, b = pad_time(a, pad, 1.0), pad_time(b, pad)
    nc = (s + pad) // chunk
    a = a.reshape(bsz, nc, chunk, d)
    b = b.reshape(bsz, nc, chunk, d)
    out_dtype = torch.promote_types(a.dtype, h0.dtype)
    # new_empty: a DTensor's buffer under a mesh, torch.empty otherwise
    h_all = a.new_empty((bsz, nc * chunk, d), dtype=out_dtype)

    def body(i, h):
        cum_a, cum_b = associative_scan(a[:, i], b[:, i])
        h_t = cum_a * h[:, None] + cum_b
        h_all[:, i * chunk:(i + 1) * chunk] = h_t
        return h_t[:, -1]

    h_f = fori_loop(0, nc, body, h0)
    return h_all[:, :s], h_f


@register_variant("rglru_scan", "offload")
def rglru_scan_offload(a, b, h0, chunk: int = 2048):
    """float32, bigger chunks — what the TPU kernel implements."""
    h_all, h_f = rglru_scan_ref(a.float(), b.float(), h0.float(), chunk=chunk)
    return h_all.to(a.dtype), h_f


def _block_diag_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [..., D]; w: [G, D/G, D/G] block-diagonal."""
    g, dg, _ = w.shape
    xs = x.reshape(x.shape[:-1] + (g, dg))
    out = torch.einsum("...gi,gio->...go", xs, w)
    return out.reshape(x.shape)


def rglru_gates(params, x: torch.Tensor):
    """Returns (a [B,S,D] decay, b [B,S,D] input) in float32."""
    xf = x.float()
    r = torch.sigmoid(_block_diag_matmul(xf, params["w_a"].float()))
    i = torch.sigmoid(_block_diag_matmul(xf, params["w_x"].float()))
    log_a = -RGLRU_C * F.softplus(params["lam"].float()) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed stably via expm1: 1-a^2 = -expm1(2 log_a)
    mult = torch.sqrt(torch.clamp_min(-torch.expm1(2.0 * log_a), 1e-12))
    b = mult * (i * xf)
    return a, b


def rglru_block(params, x, *, cfg, impl=None, state=None, length=None):
    """Griffin recurrent block.  x: [B, S, D_model] -> (y, new_state).

    ``length``: positions >= length are right-padding — their recurrence
    steps are masked to the identity (a=1, b=0) so the final state is
    exactly the state after ``length`` real tokens (bucketed prefill).
    a and b are cast to the model type before the scan, as in JAX."""
    branch = x @ params["w_branch"]                            # [B, S, d_rnn]
    gate = x @ params["w_gate"]
    conv_state = None if state is None else state["conv"]
    branch, new_conv = causal_depthwise_conv(branch, params["conv_w"],
                                             conv_state, length=length)
    a, b = rglru_gates(params, branch)
    if length is not None:
        pad = (torch.arange(x.shape[1], device=x.device) >= length)[None, :, None]
        a.masked_fill_(pad, 1.0)
        b.masked_fill_(pad, 0.0)
    h0 = (torch.zeros((x.shape[0], branch.shape[-1]), dtype=torch.float32,
                      device=x.device)
          if state is None else state["h"].float())
    h_all, h_f = dispatch("rglru_scan", impl, a.to(x.dtype), b.to(x.dtype), h0)
    y = h_all.to(x.dtype) * F.gelu(gate, approximate="tanh")
    out = y @ params["w_out"]
    return out.to(x.dtype), {"conv": new_conv, "h": h_f.float()}


def rglru_decode_step(params, x, state, *, cfg, impl=None):
    """x: [B, 1, D_model]; state: dict(conv, h [B, d_rnn]).  Returns
    (y, new_state); the caller writes the state back."""
    branch = x @ params["w_branch"]
    gate = x @ params["w_gate"]
    branch, new_conv = causal_depthwise_conv(branch, params["conv_w"],
                                             state["conv"])
    a, b = rglru_gates(params, branch)                         # [B, 1, D]
    h_new = a[:, 0] * state["h"].float() + b[:, 0]
    y = h_new[:, None, :].to(x.dtype) * F.gelu(gate, approximate="tanh")
    out = y @ params["w_out"]
    return out.to(x.dtype), {"conv": new_conv, "h": h_new}
