"""Core layer math in plain PyTorch — the port of the JAX package's
``models/layers.py``.

Precision follows the JAX code: where it asks for
``preferred_element_type=float32`` the port multiplies float32 copies of
the (bf16) operands, which gives the same exact products and a float32
sum; where JAX promotes a bf16 array by a NumPy float64 scalar (the
attention scales) the port computes in float32 too.  The unembedding
never copies its (1.3 GB at full width) weight to float32: on a card a
bf16 weight goes through one bf16 x bf16 -> float32 product.

Attention loops are :func:`~repro_torch.core.loops.fori_loop` statements,
the counterpart of the JAX ``scan``s, so the planner's loop census and
intensity analysis see them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.loops import fori_loop
from repro_torch.parallel import ctx as PC

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split halves, not interleaved)
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)                       # [head_dim/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, head_dim]; positions: broadcastable to [..., S]."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].float() * freqs             # [..., S, hd/2]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention core (region: "attn_core")
# ---------------------------------------------------------------------------
def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0, q_offset: int = 0,
                      q_chunk: int = 512, k_chunk: int = 1024) -> torch.Tensor:
    """Flash-style online-softmax attention in plain PyTorch with an
    O(q_chunk * k_chunk) working set.  q: [B, Hq, Sq, D]; k/v:
    [B, Hkv, Sk, D]; GQA: Hq must be a multiple of Hkv."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    g = hq // hkv
    q_chunk = min(q_chunk, sq)
    k_chunk = min(k_chunk, sk)
    sq_p = -(-sq // q_chunk) * q_chunk
    sk_p = -(-sk // k_chunk) * k_chunk
    qp = PC.pad(q, (0, 0, 0, sq_p - sq))
    kp = PC.pad(k, (0, 0, 0, sk_p - sk))
    vp = PC.pad(v, (0, 0, 0, sk_p - sk))
    nq, nk = sq_p // q_chunk, sk_p // k_chunk
    qp = qp.reshape(b, hkv, g, nq, q_chunk, d)
    kp = kp.reshape(b, hkv, nk, k_chunk, d)
    vp = vp.reshape(b, hkv, nk, k_chunk, d)
    scale = 1.0 / math.sqrt(d)
    dev = q.device

    def q_body(iq, out):
        qc = qp[:, :, :, iq].float() * scale                  # [B,Hkv,G,qc,D]
        q_pos = q_offset + iq * q_chunk + torch.arange(q_chunk, device=dev)

        def k_body(ik, carry):
            m, l, acc = carry
            kc = kp[:, :, ik]                                 # [B,Hkv,kc,D]
            vc = vp[:, :, ik]
            k_pos = ik * k_chunk + torch.arange(k_chunk, device=dev)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc.float())
            mask = k_pos[None, :] < sk                        # padding mask
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l_new = l * alpha + p.sum(dim=-1)
            acc_new = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(vc.dtype).float(), vc.float())
            return m_new, l_new, acc_new

        m0 = torch.full((b, hkv, g, q_chunk), NEG_INF, device=dev)
        l0 = torch.zeros((b, hkv, g, q_chunk), device=dev)
        a0 = torch.zeros((b, hkv, g, q_chunk, d), device=dev)
        m, l, acc = fori_loop(0, nk, k_body, (m0, l0, a0))
        out[:, :, :, iq] = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
        return out

    out = fori_loop(0, nq, q_body, torch.empty_like(qp))
    out = out.reshape(b, hkv, g, sq_p, d)[:, :, :, :sq]
    return out.reshape(b, hq, sq, d)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, slot_pos: torch.Tensor,
                     cur_pos: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """Single-token attention against a (possibly rotating) KV cache.
    q: [B, Hq, 1, D]; k/v_cache: [B, Hkv, S, D]; slot_pos: [B, S] absolute
    position per cache slot (-1 = empty); cur_pos: [B]."""
    b, hq, _, d = q.shape
    _, hkv, s, _ = k_cache.shape
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).float() / math.sqrt(d)
    scores = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float())
    valid = (slot_pos >= 0) & (slot_pos <= cur_pos[:, None])
    if window:
        valid = valid & (slot_pos > cur_pos[:, None] - window)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgs,bhsd->bhgd", p.float(), v_cache.float())
    return out.reshape(b, hq, 1, d).to(q.dtype)


# ---------------------------------------------------------------------------
# MLPs (regions: "mlp_core", "mlp_gelu")
# ---------------------------------------------------------------------------
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
             w_down: torch.Tensor, b_down: torch.Tensor) -> torch.Tensor:
    """``gelu(x @ w_up + b_up) @ w_down + b_down`` with the tanh form of the
    gelu, which is ``jax.nn.gelu``'s default (the erf form differs by
    ~1e-4)."""
    h = F.gelu(x @ w_up + b_up, approximate="tanh")
    return h @ w_down + b_down


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    if PC._is_dtensor(table):
        return _EmbedOnBlocks.apply(table, tokens.long())
    return table[tokens.long()]


class _EmbedOnBlocks(torch.autograd.Function):
    """``table[idx]`` on a DTensor table, whose backward adds the cotangent
    rows into each rank's own block of the table, keeping its placements.
    torch 2.11's DTensor fails the lookup's own backward (an ``index_put``
    with an unnormalized ``Shard(dim=-1)``) on a 2-D mesh.  The forward is
    the lookup as DTensor runs it."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table = (table.device_mesh, table.placements, table.shape,
                     table.stride(), PC.block_offsets(table))
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        (idx,) = ctx.saved_tensors
        mesh, placements, shape, stride, (off, size) = ctx.table
        rows, g = PC.gather_local(idx), PC.gather_local(g)
        if size[0] != shape[0]:                  # vocab rows sharded
            # rows of other blocks add an exact zero to row 0: no
            # data-dependent shape, so fake tensors (the dry-run) trace it
            rows = rows - off[0]
            keep = (rows >= 0) & (rows < size[0])
            rows = torch.where(keep, rows, 0)
            g = torch.where(keep[..., None], g, 0)
        if size[1] != shape[1]:
            g = g[..., off[1]:off[1] + size[1]]
        # on a whole table, the call autograd makes for table[idx]
        block = g.new_zeros(size).index_put_((rows,), g, accumulate=True)
        return DTensor.from_local(block, mesh, placements, run_check=False,
                                  shape=shape, stride=stride), None


class _Bf16Logits(torch.autograd.Function):
    """``torch.mm(x2, w, out_dtype=float32)`` for bf16 x2 [T, D] and w
    [D, V] (that overload has no derivative), with the backward of the CPU
    path's product of float32 copies: float32 products of the float32
    cotangent, rounded to bf16."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad
        gx = (g @ w.float().t()).to(x2.dtype) if need_x else None
        gw = (x2.float().t() @ g).to(w.dtype) if need_w else None
        return gx, gw


def unembed(x: torch.Tensor, table_or_w: torch.Tensor,
            tied: bool) -> torch.Tensor:
    """float32 logits of the bf16-rounded hidden state (as JAX: the
    activations are cast to bf16, the product accumulates in float32)."""
    w = table_or_w.t() if tied else table_or_w                # [D, V]
    xb = x.to(torch.bfloat16)
    lead = xb.shape[:-1]
    x2 = xb.reshape(-1, xb.shape[-1])
    if w.dtype == torch.bfloat16 and x2.is_cuda:
        # bf16 x bf16 -> float32 in one cuBLAS call: no float32 weight copy
        if torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad):
            out = _Bf16Logits.apply(x2, w)
        else:
            out = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        out = x2.float() @ w.float()       # .float() of a float32 w: no copy
    return out.reshape(*lead, w.shape[-1])


# ---------------------------------------------------------------------------
# KV-cache helpers
# ---------------------------------------------------------------------------
def cache_update(k_cache, v_cache, slot_pos, k_new, v_new, pos,
                 window: int = 0):
    """Write one token's k/v into the cache; rotating when windowed.

    k_cache/v_cache: [B, Hkv, S, D]; k_new/v_new: [B, Hkv, 1, D]; pos: [B].
    Unlike the JAX function this writes IN PLACE (the caches are large and
    the caller owns them) and returns the same three tensors.  DTensor
    caches (under a mesh) are written block by block
    (:func:`_cache_update_local`)."""
    if hasattr(k_cache, "device_mesh"):
        return _cache_update_local(k_cache, v_cache, slot_pos, k_new, v_new,
                                   pos, window)
    s = k_cache.shape[2]
    slot = (pos % s if window > 0 else pos.clamp_max(s - 1)).long()  # [B]
    bi = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache[bi, :, slot] = k_new[:, :, 0].to(k_cache.dtype)
    v_cache[bi, :, slot] = v_new[:, :, 0].to(v_cache.dtype)
    slot_pos[bi, slot] = pos.to(slot_pos.dtype)
    return k_cache, v_cache, slot_pos


def _cache_update_local(k_cache, v_cache, slot_pos, k_new, v_new, pos,
                        window: int):
    """:func:`cache_update` of DTensor caches ([B, Hkv, S, D] sharded on
    batch and on kv heads or ctx, by the rules): the new token's k/v and
    the positions are laid out as the cache's batch and head blocks, and
    each rank writes the rows of its block whose slot falls in its ctx
    range — no gather of the cache."""
    from torch.distributed.tensor import Replicate

    from repro_torch.parallel.ctx import block_offsets, local_region

    mesh, pl = k_cache.device_mesh, tuple(k_cache.placements)
    tok_pl = [Replicate() if p.is_shard() and p.dim == 2 else p for p in pl]
    row_pl = [p if p.is_shard() and p.dim == 0 else Replicate() for p in pl]
    kn = k_new.redistribute(mesh, tok_pl).to_local()
    vn = v_new.redistribute(mesh, tok_pl).to_local()
    pn = pos.redistribute(mesh, row_pl).to_local() if hasattr(
        pos, "device_mesh") else pos
    s = k_cache.shape[2]
    with local_region():
        slot = (pn % s if window > 0 else pn.clamp_max(s - 1)).long()
        bi = torch.arange(slot.shape[0], device=slot.device)

        def write(cache, ctx_dim, value):
            """Write ``value`` [B_loc, ...] at each row's slot of this
            rank's block of ``cache`` where the slot is in its range."""
            off, size = block_offsets(cache)
            s0, n = off[ctx_dim], size[ctx_dim]
            mine = (slot >= s0) & (slot < s0 + n)
            ls = (slot - s0).clamp(0, n - 1)
            local = cache.to_local()
            if ctx_dim == 2:
                old = local[bi, :, ls]
                local[bi, :, ls] = torch.where(mine[:, None, None],
                                               value.to(local.dtype), old)
            else:
                local[bi, ls] = torch.where(mine, value.to(local.dtype),
                                            local[bi, ls])

        write(k_cache, 2, kn[:, :, 0])
        write(v_cache, 2, vn[:, :, 0])
        write(slot_pos, 1, pn)
    return k_cache, v_cache, slot_pos
