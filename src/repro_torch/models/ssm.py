"""Mamba-1 selective-state-space block (falcon-mamba-7b) — the port of the
JAX package's ``models/ssm.py``.

Recurrence per channel c and state n:
    h_t = exp(dt_t * A[c,n]) * h_{t-1} + dt_t * B_t[n] * x_t[c]
    y_t = sum_n C_t[n] * h_t[c,n] + D[c] * x_t[c]

The ``ssm_scan`` region's variants are the JAX package's: ``ref`` runs a
log-step associative scan inside chunks of the sequence (torch has no
``associative_scan``: :func:`associative_scan` is the same odd-even
recursion as ``jax.lax.associative_scan``), ``offload`` the same in
float32 with larger chunks, and ``seq`` the time-sequential chunked scan
(the Pallas kernel's schedule), written with
:func:`~repro_torch.core.loops.fori_loop` so the planner's counting pass
runs one body.  Eager ``seq`` launches a few kernels per time step: on the
card it is slow at full size, and the serving path runs ``hopper``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.loops import fori_loop
from repro_torch.core.regions import dispatch, register_variant
from repro_torch.parallel import ctx as PC


# ---------------------------------------------------------------------------
# Depthwise causal conv (kernel size K, shift-and-add formulation)
# ---------------------------------------------------------------------------
def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                          state: torch.Tensor | None = None,
                          length: int | torch.Tensor | None = None):
    """x: [B, S, D]; w: [K, D]; state: [B, K-1, D] trailing context or None.

    ``length`` (an int or a 0-d integer tensor on x's device): only the
    first ``length`` positions of x are real — the returned state is then
    the K-1 inputs *ending at* position ``length`` (bucketed prefill
    right-pads x, and the trailing context must not contain padding),
    taken with a gather so that a tensor ``length`` needs no host sync.
    None = all S positions are real.

    Returns (y [B, S, D], new_state [B, K-1, D])."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)                        # [B, S+K-1, D]
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    if k <= 1:
        new_state = torch.zeros_like(state)
    elif length is None:
        new_state = xp[:, -(k - 1):]
    else:
        # inputs at positions [length-(K-1), length) = xp[length : length+K-1]
        idx = length + torch.arange(k - 1, device=x.device)
        new_state = xp.index_select(1, idx.to(torch.long))
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Associative scan of h_t = a_t * h_{t-1} + b_t along dim 1
# ---------------------------------------------------------------------------
def _combine(a_l, b_l, a_r, b_r):
    return a_l * a_r, b_l * a_r + b_r


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the pairs (a_t, b_t) along dim 1 under
    (a_l, b_l) . (a_r, b_r) = (a_l a_r, b_l a_r + b_r): the odd-even
    recursion of ``jax.lax.associative_scan`` (log2(S) levels, O(S) work).
    Returns (cum_a, cum_b), cum_b[:, t] = the recurrence from h = 0."""
    n = a.shape[1]
    if n < 2:
        return a, b
    # combine adjacent pairs, scan the half-length sequence, then fill in
    # the even positions from the odd prefixes
    odd_a, odd_b = associative_scan(*_combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2],
                                              a[:, 1::2], b[:, 1::2]))
    if n % 2 == 0:
        ev_a, ev_b = _combine(odd_a[:, :-1], odd_b[:, :-1], a[:, 2::2],
                              b[:, 2::2])
    else:
        ev_a, ev_b = _combine(odd_a, odd_b, a[:, 2::2], b[:, 2::2])
    ev_a = torch.cat([a[:, :1], ev_a], dim=1)
    ev_b = torch.cat([b[:, :1], ev_b], dim=1)
    # new_empty: a DTensor's buffer under a mesh, torch.empty otherwise
    out_a = ev_a.new_empty((a.shape[0], n) + ev_a.shape[2:])
    out_b = ev_b.new_empty((a.shape[0], n) + ev_b.shape[2:])
    out_a[:, 0::2], out_a[:, 1::2] = ev_a, odd_a
    out_b[:, 0::2], out_b[:, 1::2] = ev_b, odd_b
    return out_a, out_b


def pad_time(t: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    """Right-pad dim 1 of t by ``pad`` steps of ``value``."""
    if not pad:
        return t
    spec = (0, 0) * (t.dim() - 2) + (0, pad)
    return PC.pad(t, spec, value=value)


# ---------------------------------------------------------------------------
# Selective scan (region: "ssm_scan")
# ---------------------------------------------------------------------------
@register_variant("ssm_scan", "ref")
def ssm_scan_ref(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                 h0: torch.Tensor, chunk: int = 256):
    """a, bx: [B, S, D, N] (decay and input); c: [B, S, N]; h0: [B, D, N].

    Returns (y [B, S, D], h_final [B, D, N]); the state is carried in a's
    type, as in the JAX package."""
    b, s, d, n = a.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    a, bx, c = pad_time(a, pad, 1.0), pad_time(bx, pad), pad_time(c, pad)
    nc = (s + pad) // chunk
    a = a.reshape(b, nc, chunk, d, n)
    bx = bx.reshape(b, nc, chunk, d, n)
    c = c.reshape(b, nc, chunk, n)
    y = a.new_empty((b, nc * chunk, d))

    def chunk_body(i, h):
        cum_a, cum_b = associative_scan(a[:, i], bx[:, i])     # [B,chunk,D,N]
        h_t = cum_a * h[:, None] + cum_b
        y[:, i * chunk:(i + 1) * chunk] = torch.einsum("btdn,btn->btd", h_t,
                                                       c[:, i])
        return h_t[:, -1]

    h_f = fori_loop(0, nc, chunk_body, h0.to(a.dtype))
    return y[:, :s], h_f


@register_variant("ssm_scan", "offload")
def ssm_scan_offload(a, bx, c, h0, chunk: int = 512):
    """Same math, larger chunks + float32 state accumulation (the
    restructuring the TPU kernel implements); y stays float32."""
    return ssm_scan_ref(a.float(), bx.float(), c.float(), h0, chunk=chunk)


@register_variant("ssm_scan", "seq")
def ssm_scan_seq_chunked(a, bx, c, h0, chunk: int = 256):
    """Time-SEQUENTIAL chunked scan — the TPU kernel's schedule: a loop over
    chunks carrying h, a loop over the chunk's steps inside.  The JAX
    version pads the sequence to whole chunks with the identity (a=1,
    bx=0); here the last chunk is short instead, with the same result."""
    b, s, d, n = a.shape
    chunk = min(chunk, s)
    y = a.new_empty((b, s, d))

    def chunk_body(i, h):
        def step(t, hh):
            hh = a[:, t] * hh + bx[:, t]
            y[:, t] = torch.einsum("bdn,bn->bd", hh, c[:, t])
            return hh

        return fori_loop(i * chunk, min((i + 1) * chunk, s), step, h)

    h_f = fori_loop(0, -(-s // chunk), chunk_body, h0.to(a.dtype))
    return y, h_f


def ssm_decode_step(a, bx, c, h):
    """Single-token recurrence.  a, bx: [B, D, N]; c: [B, N]; h: [B, D, N]."""
    h_new = a * h + bx
    y = torch.einsum("bdn,bn->bd", h_new, c)
    return y, h_new


# ---------------------------------------------------------------------------
# Full Mamba block
# ---------------------------------------------------------------------------
def _dt_b_c(params, xi, cfg):
    dbc = xi @ params["w_dbc"]                          # [B, S, dt_rank + 2N]
    dtr, n = cfg.resolved_dt_rank, cfg.ssm_state
    dt, bmat, cmat = dbc.split([dtr, n, n], dim=-1)
    dt = F.softplus(dt @ params["w_dt"] + params["dt_bias"])   # [B, S, Di]
    a_log = -torch.exp(params["a_log"].float())                # [Di, N]
    return dt, bmat, cmat, a_log


def mamba_block(params, x, *, cfg, impl=None, state=None, length=None):
    """x: [B, S, D_model].  state: None (train) or dict(conv, h) for a
    stateful prefill.  ``length``: positions >= length are right-padding —
    their recurrence steps are masked to the identity (a=1, bx=0) so the
    final state is exactly the state after ``length`` real tokens (bucketed
    prefill).  Returns (y, new_state).

    a and bx are [B, S, d_inner, N] (545 MB each in bf16 at the full arch's
    2,080-token bucket): formed once per layer, the exp and the padding
    mask in place, and cast to the model type before the scan, as in JAX."""
    b, s, _ = x.shape
    di, n = cfg.d_inner, cfg.ssm_state
    xi, z = (x @ params["w_in"]).chunk(2, dim=-1)              # [B, S, Di]
    conv_state = None if state is None else state["conv"]
    xi, new_conv = causal_depthwise_conv(xi, params["conv_w"], conv_state,
                                         length=length)
    xi = F.silu(xi)
    dt, bmat, cmat, a_log = _dt_b_c(params, xi, cfg)
    a = (dt[..., None].float() * a_log).exp_()                # [B, S, Di, N]
    bx = (dt * xi)[..., None] * bmat[:, :, None, :]            # [B, S, Di, N]
    if length is not None:
        pad = (torch.arange(s, device=x.device) >= length)[None, :, None, None]
        a.masked_fill_(pad, 1.0)
        bx.masked_fill_(pad, 0.0)
    h0 = (torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
          if state is None else state["h"].float())
    y, h_f = dispatch("ssm_scan", impl, a.to(x.dtype), bx.to(x.dtype),
                      cmat.to(x.dtype).contiguous(), h0)
    del a, bx
    y = y + xi * params["d_skip"]
    y = y * F.silu(z)
    # offload's y is float32: JAX promotes the bf16 weight to it, torch
    # refuses mixed types
    out = y @ params["w_out"].to(y.dtype)
    return out.to(x.dtype), {"conv": new_conv, "h": h_f.float()}


def mamba_decode_step(params, x, state, *, cfg, impl=None):
    """x: [B, 1, D_model]; state: dict(conv [B, K-1, Di], h [B, Di, N]).
    Returns (y, new_state); the caller writes the state back."""
    xi, z = (x @ params["w_in"]).chunk(2, dim=-1)              # [B, 1, Di]
    xi, new_conv = causal_depthwise_conv(xi, params["conv_w"], state["conv"])
    xi = F.silu(xi)
    dt, bmat, cmat, a_log = _dt_b_c(params, xi, cfg)
    a = torch.exp(dt[:, 0, :, None].float() * a_log)           # [B, Di, N]
    bx = (dt * xi)[:, 0, :, None] * bmat[:, 0, None, :]        # [B, Di, N]
    y, h_new = ssm_decode_step(a.float(), bx.float(), cmat[:, 0].float(),
                               state["h"])
    y = y[:, None, :].to(x.dtype) + xi * params["d_skip"]
    y = y * F.silu(z)
    out = y @ params["w_out"]
    return out.to(x.dtype), {"conv": new_conv, "h": h_new}
