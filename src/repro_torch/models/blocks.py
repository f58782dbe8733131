"""Per-layer block templates and apply functions — the port of the JAX
package's ``models/blocks.py``: attention (full and sliding-window, GQA,
and cross-attention to an encoder's output), the SwiGLU and gelu MLPs,
the Mixture-of-Experts FFN (with arctic's parallel dense residual MLP),
whisper's conv stem, the Mamba-1 SSM block and the RG-LRU block.

Each block kind provides ``<kind>_template(cfg)`` (a ParamSpec tree, one
layer, unstacked), ``<kind>_apply`` (full sequence) and, for the kinds
with a cache, ``<kind>_decode`` (one token against the cache) and
``<kind>_cache_template``.  Decode writes the cache IN PLACE and returns
it.  Blocks route their hot loops through
:func:`repro_torch.core.regions.dispatch`, so the planner can swap
implementations.  The JAX sharding constraints have no counterpart on one
card.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.regions import dispatch, register_variant
from repro_torch.kernels import ops as _ops  # noqa: F401 (registers hopper)
from repro_torch.models import layers as L
from repro_torch.models import moe as _moe  # noqa: F401 (registers moe_*)
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SS
from repro_torch.models.params import spec

# ---------------------------------------------------------------------------
# attn_core / mlp_core / mlp_gelu / conv_stem region variants
# ---------------------------------------------------------------------------
register_variant("attn_core", "ref")(
    lambda q, k, v, **kw: L.chunked_attention(q, k, v, q_chunk=512,
                                              k_chunk=1024, **kw))
register_variant("attn_core", "offload")(
    lambda q, k, v, **kw: L.chunked_attention(q, k, v, q_chunk=1024,
                                              k_chunk=2048, **kw))


@register_variant("mlp_core", "ref")
def _mlp_ref(x, w_gate, w_up, w_down):
    return L.swiglu(x, w_gate, w_up, w_down)


@register_variant("mlp_core", "offload")
def _mlp_offload(x, w_gate, w_up, w_down):
    # fused formulation: one concatenated matmul then split (one pass over x)
    h = x @ torch.cat([w_gate, w_up], dim=1)
    g, u = h.chunk(2, dim=-1)
    return (F.silu(g) * u) @ w_down


@register_variant("mlp_gelu", "ref")
def _mlp_gelu_ref(x, w_up, b_up, w_down, b_down):
    return L.gelu_mlp(x, w_up, b_up, w_down, b_down)


@register_variant("mlp_gelu", "offload")
def _mlp_gelu_offload(x, w_up, b_up, w_down, b_down):
    # one pass with the first product accumulated in float32 and the bias
    # added before the gelu (what a fused gelu-MLP kernel computes)
    h = x.float() @ w_up.float() + b_up.float()
    g = F.gelu(h, approximate="tanh").to(x.dtype)
    return (g @ w_down + b_down).to(x.dtype)


def same_pad(win: int, k: int, stride: int) -> tuple[int, int, int]:
    """(out_w, lo, hi) of a "SAME"-padded strided window: XLA's split, the
    odd element of the padding on the high side."""
    out_w = -(-win // stride)
    total = max((out_w - 1) * stride + k - win, 0)
    return out_w, total // 2, total - total // 2


@register_variant("conv_stem", "ref")
def _conv_stem_ref(x, w, b, *, stride=1):
    # x: [B, W, Cin]; w: [K, Cin, Cout] (HIO, whisper's k=3 conv1d stem
    # layer); a "SAME"-padded strided conv1d, then gelu(h + b)
    _, lo, hi = same_pad(x.shape[1], w.shape[0], stride)
    xt = F.pad(x.transpose(1, 2), (lo, hi))                 # [B, Cin, W']
    h = F.conv1d(xt, w.permute(2, 1, 0), stride=stride)     # [B, Cout, out_w]
    # back to a contiguous [B, out_w, Cout], the layout the offload form
    # returns (the encoder's matmuls then fold their rows into one mm)
    h = h.transpose(1, 2).contiguous()
    return F.gelu(h + b, approximate="tanh")


@register_variant("conv_stem", "offload")
def _conv_stem_offload(x, w, b, *, stride=1):
    # im2col: gather the K strided windows and run ONE matmul (conv as a
    # dense GEMM)
    k, cin, cout = w.shape
    out_w, lo, hi = same_pad(x.shape[1], k, stride)
    xp = F.pad(x, (0, 0, lo, hi))
    span = (out_w - 1) * stride + 1
    cols = torch.cat([xp[:, i:i + span:stride] for i in range(k)],
                     dim=-1)                                # [B, out_w, K*Cin]
    h = cols @ w.reshape(k * cin, cout)
    return F.gelu(h + b, approximate="tanh")


# ---------------------------------------------------------------------------
# Attention block
# ---------------------------------------------------------------------------
def attn_template(cfg: ModelConfig) -> dict:
    d, hq, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    t = {
        "ln": spec([d], ("embed",), "zeros"),
        "wq": spec([d, hq * hd], ("embed", "qkv")),
        "wk": spec([d, hkv * hd], ("embed", "kv_qkv")),
        "wv": spec([d, hkv * hd], ("embed", "kv_qkv")),
        "wo": spec([hq * hd, d], ("qkv", "embed"), "scaled"),
    }
    if cfg.qkv_bias:
        t["bq"] = spec([hq * hd], ("qkv",), "zeros")
        t["bk"] = spec([hkv * hd], ("kv_qkv",), "zeros")
        t["bv"] = spec([hkv * hd], ("kv_qkv",), "zeros")
    return t


def _split_heads(x, n_heads, hd):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, hd).transpose(1, 2)      # [B, H, S, hd]


def _merge_heads(x):
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def _qkv(p, h, kv_src, cfg):
    hd = cfg.resolved_head_dim
    q = h @ p["wq"]
    k = kv_src @ p["wk"]
    v = kv_src @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (_split_heads(q, cfg.num_heads, hd),
            _split_heads(k, cfg.num_kv_heads, hd),
            _split_heads(v, cfg.num_kv_heads, hd))


def attn_apply(p, x, *, cfg: ModelConfig, positions, impl=None, causal=True,
               window=0, kv_src=None, kv_positions=None, return_kv=False):
    """Full-sequence attention block with pre-norm residual.
    x: [B, S, D]; positions: [B, S] absolute positions.  ``kv_src``: the
    encoder's output [B, S_enc, D] for cross-attention (k and v come from
    it, unnormed, at ``kv_positions``), else self-attention.  With
    ``return_kv`` also returns the roped k and v ([B, Hkv, S_kv, hd])."""
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(p, h, h if kv_src is None else kv_src, cfg)
    kpos = positions if kv_positions is None else kv_positions
    q = L.apply_rope(q, positions[:, None, :], cfg.rope_theta)
    k = L.apply_rope(k, kpos[:, None, :], cfg.rope_theta)
    # the kernels take contiguous [B, H, S, hd] tensors
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = dispatch("attn_core", impl, q, k, v, causal=causal, window=window)
    out = _merge_heads(out) @ p["wo"]
    res = x + out.to(x.dtype)
    if return_kv:
        return res, (k, v)
    return res


def attn_cache_template(cfg: ModelConfig, batch: int, ctx: int,
                        window: int = 0) -> dict:
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    s = min(ctx, window) if window else ctx
    return {
        "k": spec([batch, hkv, s, hd], ("batch", "kv_heads", "ctx", None),
                  "zeros"),
        "v": spec([batch, hkv, s, hd], ("batch", "kv_heads", "ctx", None),
                  "zeros"),
        "slot_pos": spec([batch, s], ("batch", "ctx"), "neg_ones_i32",
                         dtype="int32"),
    }


def attn_decode(p, x, cache, *, cfg: ModelConfig, pos, window=0,
                cross_kv=None):
    """x: [B, 1, D]; pos: [B] absolute position of this token.  Writes the
    token's k/v into ``cache`` in place and returns (x, cache).  The
    attention itself is the plain ``layers.decode_attention``, as in the
    JAX package (the ``decode_attn`` region is planned on its own).

    ``cross_kv``: (k, v, slot_pos) of the encoder's output, written at
    prefill; the token attends to every slot of it (its "current position"
    2**30 lies past all of them, and in int32) and writes nothing."""
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    if cross_kv is not None:
        k_cache, v_cache, slot_pos = cross_kv
        q = h @ p["wq"]
        if "bq" in p:
            q = q + p["bq"]
        q = _split_heads(q, cfg.num_heads, cfg.resolved_head_dim)
        q = L.apply_rope(q, pos[:, None, None], cfg.rope_theta)
        out = L.decode_attention(q, k_cache, v_cache, slot_pos,
                                 torch.full_like(pos, 2**30), window=0)
        out = _merge_heads(out) @ p["wo"]
        return x + out.to(x.dtype), cache
    q, k_new, v_new = _qkv(p, h, h, cfg)
    q = L.apply_rope(q, pos[:, None, None], cfg.rope_theta)
    k_new = L.apply_rope(k_new, pos[:, None, None], cfg.rope_theta)
    k_c, v_c, sp = L.cache_update(cache["k"], cache["v"], cache["slot_pos"],
                                  k_new, v_new, pos, window=window)
    out = L.decode_attention(q, k_c, v_c, sp, pos, window=window)
    out = _merge_heads(out) @ p["wo"]
    return x + out.to(x.dtype), cache


def attn_prefill_cache(k, v, *, positions, window=0, ctx=None,
                       length=None) -> dict:
    """The KV cache after a prefill, from the block's roped k and v
    ([B, Hkv, S, hd]).  The JAX package recomputes k and v inside
    ``attn_prefill_cache``; the port takes them from ``attn_apply`` (the
    same operations on the same inputs).

    ``length`` (int): only positions < length are real (bucketed prefill
    right-pads the sequence).  Slot j then holds the newest valid position
    p with p % size == j (the slot discipline ``cache_update`` uses at
    decode), and unfilled slots are zeroed with slot_pos = -1 so decode
    attention masks them."""
    b, hkv, s, hd = k.shape
    dev = k.device
    size = min(ctx or s, window) if window else (ctx or s)
    if length is not None:
        # slot j <- newest position p < length with p = j (mod size): one
        # formula for the full cache and the rotating window
        j = torch.arange(size, device=dev)
        p_j = length - 1 - torch.remainder(length - 1 - j, size)   # [size]
        valid = p_j >= 0
        gather = p_j.clamp(0, s - 1)
        m = valid[None, None, :, None]
        kc = torch.where(m, k[:, :, gather], torch.zeros((), dtype=k.dtype,
                                                          device=dev))
        vc = torch.where(m, v[:, :, gather], torch.zeros((), dtype=v.dtype,
                                                          device=dev))
        sp = torch.where(valid, p_j, -1)[None, :].expand(b, size)
        return {"k": kc, "v": vc, "slot_pos": sp.to(torch.int32).contiguous()}
    if window and s > size:
        # keep the last `size` positions at slots pos % size
        keep_pos = positions[:, -size:]                        # [B, size]
        slots = keep_pos % size
        kc = torch.zeros((b, hkv, size, hd), dtype=k.dtype, device=dev)
        vc = torch.zeros((b, hkv, size, hd), dtype=v.dtype, device=dev)
        sp = torch.full((b, size), -1, dtype=torch.int32, device=dev)
        bi = torch.arange(b, device=dev)[:, None]
        kc[bi, :, slots] = k[:, :, -size:].transpose(1, 2)
        vc[bi, :, slots] = v[:, :, -size:].transpose(1, 2)
        sp[bi, slots] = keep_pos.to(torch.int32)
        return {"k": kc, "v": vc, "slot_pos": sp}
    pad = size - s
    kc = F.pad(k, (0, 0, 0, pad))
    vc = F.pad(v, (0, 0, 0, pad))
    sp = F.pad(positions, (0, pad), value=-1)
    return {"k": kc, "v": vc, "slot_pos": sp.to(torch.int32)}


# ---------------------------------------------------------------------------
# Dense MLP block
# ---------------------------------------------------------------------------
def mlp_template(cfg: ModelConfig, d_ff: Optional[int] = None,
                 gelu: bool = False) -> dict:
    """SwiGLU weights, or with ``gelu`` the biased up/down pair of the gelu
    MLP (whisper's)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    t = {"ln": spec([d], ("embed",), "zeros")}
    if gelu:
        t.update(w_up=spec([d, f], ("embed", "mlp")),
                 b_up=spec([f], ("mlp",), "zeros"),
                 w_down=spec([f, d], ("mlp", "embed"), "scaled"),
                 b_down=spec([d], ("embed",), "zeros"))
    else:
        t.update(w_gate=spec([d, f], ("embed", "mlp")),
                 w_up=spec([d, f], ("embed", "mlp")),
                 w_down=spec([f, d], ("mlp", "embed"), "scaled"))
    return t


def mlp_apply(p, x, *, cfg: ModelConfig, impl=None):
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    if "w_gate" in p:
        out = dispatch("mlp_core", impl, h, p["w_gate"], p["w_up"],
                       p["w_down"])
    else:
        out = dispatch("mlp_gelu", impl, h, p["w_up"], p["b_up"],
                       p["w_down"], p["b_down"])
    return x + out.to(x.dtype)


# ---------------------------------------------------------------------------
# MoE block
# ---------------------------------------------------------------------------
def moe_template(cfg: ModelConfig) -> dict:
    d, e = cfg.d_model, cfg.num_experts
    f = cfg.moe_d_ff or cfg.d_ff
    t = {
        "ln": spec([d], ("embed",), "zeros"),
        "router": spec([d, e], ("embed", "experts")),
        "w_gate": spec([e, d, f], ("experts", "embed", "expert_mlp")),
        "w_up": spec([e, d, f], ("experts", "embed", "expert_mlp")),
        "w_down": spec([e, f, d], ("experts", "expert_mlp", "embed"),
                       "scaled"),
    }
    if cfg.dense_residual_d_ff:
        t["dense"] = {k: v for k, v in
                      mlp_template(cfg, d_ff=cfg.dense_residual_d_ff).items()
                      if k != "ln"}
    return t


def moe_apply(p, x, *, cfg: ModelConfig, impl=None):
    """Pre-norm MoE FFN over the flattened [B*S, D] tokens (every token of
    the batch, padding included, competes for the experts' capacity), plus
    the parallel dense residual MLP where the config has one."""
    b, s, d = x.shape
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    moe_out = dispatch("moe_ffn", impl, h.reshape(b * s, d),
                       {k: p[k] for k in ("router", "w_gate", "w_up",
                                          "w_down")},
                       num_experts=cfg.num_experts, k=cfg.experts_per_token,
                       capacity_factor=cfg.capacity_factor, inner_impl=impl)
    out = moe_out.reshape(b, s, d)
    if "dense" in p:
        dp = p["dense"]
        out = out + L.swiglu(h, dp["w_gate"], dp["w_up"],
                             dp["w_down"]).to(x.dtype)
    return x + out.to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba (SSM) block
# ---------------------------------------------------------------------------
def ssm_template(cfg: ModelConfig) -> dict:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr, k = cfg.resolved_dt_rank, cfg.ssm_conv
    return {
        "ln": spec([d], ("embed",), "zeros"),
        "w_in": spec([d, 2 * di], ("embed", "inner2")),
        "conv_w": spec([k, di], (None, "inner"), "normal", scale=0.3),
        "w_dbc": spec([di, dtr + 2 * n], ("inner", None)),
        "w_dt": spec([dtr, di], (None, "inner")),
        "dt_bias": spec([di], ("inner",), "zeros"),
        "a_log": spec([di, n], ("inner", None), "a_log", dtype="float32"),
        "d_skip": spec([di], ("inner",), "ones"),
        "w_out": spec([di, d], ("inner", "embed"), "scaled"),
    }


def ssm_cache_template(cfg: ModelConfig, batch: int) -> dict:
    di, n, k = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {
        "conv": spec([batch, k - 1, di], ("batch", None, "inner"), "zeros"),
        "h": spec([batch, di, n], ("batch", "inner", None), "zeros",
                  dtype="float32"),
    }


def ssm_apply(p, x, *, cfg: ModelConfig, impl=None, state=None, length=None):
    """Returns (x, state after the sequence)."""
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    out, new_state = SS.mamba_block(p, h, cfg=cfg, impl=impl, state=state,
                                    length=length)
    return x + out, new_state


def _write_state(cache: dict, new_state: dict) -> dict:
    for name, dst in cache.items():
        dst.copy_(new_state[name])
    return cache


def ssm_decode(p, x, cache, *, cfg: ModelConfig, impl=None):
    """x: [B, 1, D]; writes the new conv and h state into ``cache`` in
    place and returns (x, cache)."""
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    out, new_state = SS.mamba_decode_step(p, h, cache, cfg=cfg, impl=impl)
    return x + out, _write_state(cache, new_state)


# ---------------------------------------------------------------------------
# RG-LRU block
# ---------------------------------------------------------------------------
def rglru_template(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    dr = cfg.rglru_d_rnn or d
    g = 8 if dr % 8 == 0 else 1
    k = cfg.ssm_conv
    return {
        "ln": spec([d], ("embed",), "zeros"),
        "w_branch": spec([d, dr], ("embed", "rnn")),
        "w_gate": spec([d, dr], ("embed", "rnn")),
        "conv_w": spec([k, dr], (None, "rnn"), "normal", scale=0.3),
        "w_a": spec([g, dr // g, dr // g], (None, None, None), "normal",
                    scale=0.3),
        "w_x": spec([g, dr // g, dr // g], (None, None, None), "normal",
                    scale=0.3),
        "lam": spec([dr], ("rnn",), "ones"),
        "w_out": spec([dr, d], ("rnn", "embed"), "scaled"),
    }


def rglru_cache_template(cfg: ModelConfig, batch: int) -> dict:
    dr = cfg.rglru_d_rnn or cfg.d_model
    k = cfg.ssm_conv
    return {
        "conv": spec([batch, k - 1, dr], ("batch", None, "rnn"), "zeros"),
        "h": spec([batch, dr], ("batch", "rnn"), "zeros", dtype="float32"),
    }


def rglru_apply(p, x, *, cfg: ModelConfig, impl=None, state=None,
                length=None):
    """Returns (x, state after the sequence)."""
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    out, new_state = RG.rglru_block(p, h, cfg=cfg, impl=impl, state=state,
                                    length=length)
    return x + out, new_state


def rglru_decode(p, x, cache, *, cfg: ModelConfig, impl=None):
    """x: [B, 1, D]; writes the new conv and h state into ``cache`` in
    place and returns (x, cache)."""
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    out, new_state = RG.rglru_decode_step(p, h, cache, cfg=cfg, impl=impl)
    return x + out, _write_state(cache, new_state)
