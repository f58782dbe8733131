"""Model assembly: templates, full-sequence forward, prefill, decode — the
port of the JAX package's ``models/lm.py``: decoders of attention, SSM and
RG-LRU layers, whose attention layers may carry a Mixture-of-Experts FFN,
and the two frontends.  paligemma-3b prepends its (stubbed) SigLIP patch
embeddings, projected by ``w_front``, to the decoder's tokens; whisper-small
runs its mel frames through a conv stem and an encoder, and every decoder
layer cross-attends to the encoder's output.

Per-layer parameters are stacked along a leading ``layers`` axis, as in the
JAX tree (so the two packages' trees convert leaf for leaf, see
``models/convert.py``).  The JAX ``scan`` over the stack becomes a
:func:`~repro_torch.core.loops.fori_loop` over layer views: a Python loop
when run, one body run under the planner's counting pass.

Hybrid archs (recurrentgemma) repeat a block *pattern*: the loop runs over
whole pattern repetitions ("units") and the non-multiple tail is applied
unstacked — 26 layers of (RGLRU, RGLRU, LOCAL) = 8 units + a 2-layer tail,
whose params and caches are [B, ...] rather than [layers, B, ...].

Caches are updated in place: ``prefill`` fills a cache it allocates,
``decode_step`` writes the new token's k/v (or recurrent state) into the
cache it is given and returns that same cache.  A cross-attending layer's
cache also holds ``xkv``, the k and v of the encoder's output, written at
prefill and read at every decode step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import ATTN, LOCAL_ATTN, RGLRU, SSM, ModelConfig
from repro_torch.core.loops import fori_loop
from repro_torch.core.regions import dispatch
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.params import DTYPES, spec, stack_tree, tree_map


def _check_kind(kind: str) -> None:
    if kind not in (ATTN, LOCAL_ATTN, RGLRU, SSM):
        raise ValueError(f"unknown layer kind {kind!r}")


def _check_cfg(cfg: ModelConfig) -> None:
    for kind in cfg.layer_kinds():
        _check_kind(kind)


# ---------------------------------------------------------------------------
# Layer plan
# ---------------------------------------------------------------------------
def layer_plan(cfg: ModelConfig) -> tuple[tuple[str, ...], int, tuple[str, ...]]:
    """Returns (unit_kinds, reps, tail_kinds)."""
    kinds = cfg.layer_kinds()
    if cfg.layer_pattern:
        m = len(cfg.layer_pattern)
        reps = len(kinds) // m
        return tuple(cfg.layer_pattern), reps, tuple(kinds[reps * m:])
    return (kinds[0],), len(kinds), ()


def _cast_tree(t, cfg: ModelConfig):
    if cfg.dtype == "bfloat16":
        return t
    return tree_map(lambda s: dataclasses.replace(s, dtype=cfg.dtype)
                    if s.dtype == "bfloat16" else s, t)


def layer_template(cfg: ModelConfig, kind: str) -> dict:
    _check_kind(kind)
    if kind == RGLRU:
        t = {"rglru": B.rglru_template(cfg)}
    elif kind == SSM:
        t = {"ssm": B.ssm_template(cfg)}
    else:
        t = {"attn": B.attn_template(cfg)}
        if cfg.cross_attention:
            t["xattn"] = B.attn_template(cfg)
    if cfg.d_ff:
        t["ffn"] = (B.moe_template(cfg) if _moe_layer(cfg, kind)
                    else B.mlp_template(cfg, gelu=cfg.family == "audio"))
    return t


def model_template(cfg: ModelConfig) -> dict:
    _check_cfg(cfg)
    d = cfg.d_model
    t: dict = {
        "embed": spec([cfg.vocab_size, d], ("vocab", "embed"), scale=1.0),
        "final_ln": spec([d], ("embed",), "zeros"),
    }
    if not cfg.tie_embeddings:
        t["unembed"] = spec([d, cfg.vocab_size], ("embed", "vocab"))
    if cfg.frontend != "none":
        if cfg.conv_stem:
            # whisper's two k=3 conv1d layers: stride 1 (mel -> d), then
            # stride 2 (d -> d, halving the frames to encoder_seq)
            t["stem"] = {
                "w1": spec([3, cfg.frontend_dim, d],
                           (None, "frontend", "embed")),
                "b1": spec([d], ("embed",), "zeros"),
                "w2": spec([3, d, d], (None, None, "embed")),
                "b2": spec([d], ("embed",), "zeros"),
            }
        else:
            t["w_front"] = spec([cfg.frontend_dim, d], ("frontend", "embed"))
    if cfg.encoder_layers:
        enc_unit = {"attn": B.attn_template(cfg),
                    "ffn": B.mlp_template(cfg, gelu=True)}
        t["encoder"] = {"stack": stack_tree(cfg.encoder_layers, enc_unit),
                        "ln": spec([d], ("embed",), "zeros")}
    unit_kinds, reps, tail_kinds = layer_plan(cfg)
    unit = {f"l{i}": layer_template(cfg, k) for i, k in enumerate(unit_kinds)}
    t["stack"] = stack_tree(reps, unit)
    if tail_kinds:
        t["tail"] = {f"l{i}": layer_template(cfg, k)
                     for i, k in enumerate(tail_kinds)}
    return _cast_tree(t, cfg)


# ---------------------------------------------------------------------------
# Cache templates
# ---------------------------------------------------------------------------
def layer_cache_template(cfg: ModelConfig, kind: str, batch: int,
                         ctx: int) -> dict:
    _check_kind(kind)
    if kind == RGLRU:
        return {"rglru": B.rglru_cache_template(cfg, batch)}
    if kind == SSM:
        return {"ssm": B.ssm_cache_template(cfg, batch)}
    if kind == LOCAL_ATTN:
        return {"attn": B.attn_cache_template(cfg, batch, ctx,
                                              window=cfg.attn_window)}
    t = {"attn": B.attn_cache_template(cfg, batch, ctx)}
    if cfg.cross_attention:
        shape = [batch, cfg.num_kv_heads, cfg.encoder_seq,
                 cfg.resolved_head_dim]
        axes = ("batch", "kv_heads", None, None)
        t["xkv"] = {"k": spec(shape, axes, "zeros"),
                    "v": spec(shape, axes, "zeros")}
    return t


def cache_template(cfg: ModelConfig, batch: int, ctx: int) -> dict:
    _check_cfg(cfg)
    unit_kinds, reps, tail_kinds = layer_plan(cfg)
    unit = {f"l{i}": layer_cache_template(cfg, k, batch, ctx)
            for i, k in enumerate(unit_kinds)}
    t = {"stack": stack_tree(reps, unit)}
    if tail_kinds:
        t["tail"] = {f"l{i}": layer_cache_template(cfg, k, batch, ctx)
                     for i, k in enumerate(tail_kinds)}
    return _cast_tree(t, cfg)


def _empty(template, device) -> dict:
    return tree_map(lambda s: torch.empty(s.shape, dtype=DTYPES[s.dtype],
                                          device=device), template)


def _layer(tree, i: int):
    """Views of layer ``i`` of a stacked tree."""
    return tree_map(lambda t: t[i], tree)


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.attn_window if kind == LOCAL_ATTN else 0


def _moe_layer(cfg: ModelConfig, kind: str) -> bool:
    """MoE configs route the FFN of their attention layers (JAX: the
    recurrent kinds keep a dense MLP)."""
    return cfg.is_moe and kind in (ATTN, LOCAL_ATTN)


def _ffn(p, x, *, cfg: ModelConfig, kind: str, impl):
    if _moe_layer(cfg, kind):
        return B.moe_apply(p["ffn"], x, cfg=cfg, impl=impl)
    return B.mlp_apply(p["ffn"], x, cfg=cfg, impl=impl)


# ---------------------------------------------------------------------------
# Unit application (one pattern repetition)
# ---------------------------------------------------------------------------
def _apply_unit_seq(unit_params, x, *, cfg, kinds, positions, impl, enc):
    """``enc``: (encoder output, its positions) of a cross-attending
    model, else None."""
    for i, kind in enumerate(kinds):
        p = unit_params[f"l{i}"]
        if kind == RGLRU:
            x, _ = B.rglru_apply(p["rglru"], x, cfg=cfg, impl=impl)
        elif kind == SSM:
            x, _ = B.ssm_apply(p["ssm"], x, cfg=cfg, impl=impl)
        else:
            x = B.attn_apply(p["attn"], x, cfg=cfg, positions=positions,
                             impl=impl, causal=True,
                             window=_window(cfg, kind))
            if cfg.cross_attention:
                x = B.attn_apply(p["xattn"], x, cfg=cfg, positions=positions,
                                 impl=impl, causal=False, kv_src=enc[0],
                                 kv_positions=enc[1])
        if cfg.d_ff:
            x = _ffn(p, x, cfg=cfg, kind=kind, impl=impl)
    return x


def _apply_unit_seq_exact(unit_params, unit_cache, x, *, cfg, kinds,
                          positions, impl, enc, ctx, length=None):
    """Like :func:`_apply_unit_seq`, and writes the caches into
    ``unit_cache``.  ``length``: positions >= length are right-padding
    (bucketed prefill); attention is exact under the causal mask, so the
    padding only has to be masked out of the KV caches and the recurrent
    state updates."""
    for i, kind in enumerate(kinds):
        p = unit_params[f"l{i}"]
        c: dict = {}
        if kind == RGLRU:
            x, c["rglru"] = B.rglru_apply(p["rglru"], x, cfg=cfg, impl=impl,
                                          length=length)
        elif kind == SSM:
            x, c["ssm"] = B.ssm_apply(p["ssm"], x, cfg=cfg, impl=impl,
                                      length=length)
        else:
            window = _window(cfg, kind)
            x, (k, v) = B.attn_apply(p["attn"], x, cfg=cfg,
                                     positions=positions, impl=impl,
                                     causal=True, window=window,
                                     return_kv=True)
            c["attn"] = B.attn_prefill_cache(k, v, positions=positions,
                                             window=window, ctx=ctx,
                                             length=length)
            if cfg.cross_attention:
                x, (xk, xv) = B.attn_apply(
                    p["xattn"], x, cfg=cfg, positions=positions, impl=impl,
                    causal=False, kv_src=enc[0], kv_positions=enc[1],
                    return_kv=True)
                c["xkv"] = {"k": xk, "v": xv}
        for block, dsts in unit_cache[f"l{i}"].items():
            for name, dst in dsts.items():
                dst.copy_(c[block][name])
        if cfg.d_ff:
            x = _ffn(p, x, cfg=cfg, kind=kind, impl=impl)
    return x


def _apply_unit_decode(unit_params, unit_cache, x, *, cfg, kinds, pos, impl):
    for i, kind in enumerate(kinds):
        p, c = unit_params[f"l{i}"], unit_cache[f"l{i}"]
        if kind == RGLRU:
            x, _ = B.rglru_decode(p["rglru"], x, c["rglru"], cfg=cfg, impl=impl)
        elif kind == SSM:
            x, _ = B.ssm_decode(p["ssm"], x, c["ssm"], cfg=cfg, impl=impl)
        else:
            x, _ = B.attn_decode(p["attn"], x, c["attn"], cfg=cfg, pos=pos,
                                 window=_window(cfg, kind))
            if cfg.cross_attention:
                xkv = c["xkv"]
                enc_sp = torch.arange(cfg.encoder_seq, dtype=torch.int32,
                                      device=x.device)[None].expand(
                                          x.shape[0], cfg.encoder_seq)
                x, _ = B.attn_decode(p["xattn"], x, None, cfg=cfg, pos=pos,
                                     cross_kv=(xkv["k"], xkv["v"], enc_sp))
        if cfg.d_ff:
            x = _ffn(p, x, cfg=cfg, kind=kind, impl=impl)
    return x


# ---------------------------------------------------------------------------
# Encoder (whisper)
# ---------------------------------------------------------------------------
def encode(params, frames, *, cfg: ModelConfig, impl=None):
    """frames: [B, S_frames, frontend_dim] -> [B, S_enc, D].

    With ``cfg.conv_stem`` the frames pass through whisper's two k=3 conv1d
    layers (stride 1, then stride 2, a gelu after each: the ``conv_stem``
    region), so S_enc = S_frames / 2; otherwise one linear projection,
    S_enc = S_frames.  Then the encoder's bidirectional attention and gelu
    MLP layers, and its final norm.  ``frames`` may come in float32 holding
    bf16 values (NumPy has no bf16): they are cast to the weights' type on
    the device."""
    dt = DTYPES[cfg.dtype]
    if "stem" in params:
        st = params["stem"]
        x = frames.to(st["w1"].dtype)         # the conv takes one type
        x = dispatch("conv_stem", impl, x, st["w1"], st["b1"], stride=1)
        x = dispatch("conv_stem", impl, x.to(st["w2"].dtype), st["w2"],
                     st["b2"], stride=2)
        x = x.to(dt)
    else:
        w = params["w_front"]
        x = (frames.to(w.dtype) @ w).to(dt)
    positions = _positions(x)
    enc = params["encoder"]

    def body(i, x):
        p = _layer(enc["stack"], i)
        x = B.attn_apply(p["attn"], x, cfg=cfg, positions=positions,
                         impl=impl, causal=False)
        return B.mlp_apply(p["ffn"], x, cfg=cfg, impl=impl)

    x = fori_loop(0, cfg.encoder_layers, body, x)
    return L.rms_norm(x, enc["ln"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------
def _embed(params, cfg: ModelConfig, tokens):
    # bf16 table row times a Python float stays bf16, as in JAX
    x = L.embed(tokens, params["embed"]) * math.sqrt(cfg.d_model)
    return x.to(DTYPES[cfg.dtype])


def _embed_inputs(params, cfg: ModelConfig, tokens, frontend_emb):
    """(x, n_front): the scaled token embeddings, behind the projected
    patch embeddings of a SigLIP-stub model when it is given them (the
    patches are not scaled by sqrt(d)).  n_front = prefix length."""
    x = _embed(params, cfg, tokens)
    if cfg.frontend != "siglip_stub" or frontend_emb is None:
        return x, 0
    w = params["w_front"]
    fe = (frontend_emb.to(w.dtype) @ w).to(x.dtype)
    return torch.cat([fe, x], dim=1), fe.shape[1]


def _encoded(params, cfg: ModelConfig, frontend_emb, impl):
    """(encoder output, its positions) of an encoder-decoder model, else
    None."""
    if not cfg.encoder_layers:
        return None
    if frontend_emb is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder arch: its "
                         "forward, prefill and serving need the frames")
    out = encode(params, frontend_emb, cfg=cfg, impl=impl)
    return out, _positions(out)


def _positions(x) -> torch.Tensor:
    bsz, s = x.shape[:2]
    return torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(
        bsz, s)


def _logits(params, x, cfg: ModelConfig):
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.unembed(x, table, cfg.tie_embeddings)


def forward(params, tokens, *, cfg: ModelConfig, impl=None,
            frontend_emb=None):
    """Training/scoring forward.  tokens: [B, S] int; ``frontend_emb``: a
    frontend model's patch embeddings [B, S_f, frontend_dim] (prepended;
    optional) or mel frames [B, S_frames, frontend_dim] (encoded;
    required).  Returns float32 logits [B, S, vocab] of the token
    positions."""
    x, n_front = _embed_inputs(params, cfg, tokens, frontend_emb)
    positions = _positions(x)
    enc = _encoded(params, cfg, frontend_emb, impl)
    unit_kinds, reps, tail_kinds = layer_plan(cfg)

    def unit_body(i, x):
        return _apply_unit_seq(_layer(params["stack"], i), x, cfg=cfg,
                               kinds=unit_kinds, positions=positions,
                               impl=impl, enc=enc)

    x = fori_loop(0, reps, unit_body, x)
    if tail_kinds:
        x = _apply_unit_seq(params["tail"], x, cfg=cfg, kinds=tail_kinds,
                            positions=positions, impl=impl, enc=enc)
    return _logits(params, x[:, n_front:], cfg)


def prefill(params, tokens, *, cfg: ModelConfig, impl=None,
            frontend_emb=None, ctx: Optional[int] = None,
            length: Optional[int] = None):
    """Prefill: forward + exact KV caches.  Returns (logits_last [B, 1, V],
    cache).

    frontend_emb: as in :func:`forward`.  A patch prefix is always real and
    counts toward the cache (it takes positions [0, n_front)); whisper's
    frames are encoded, and each layer's ``xkv`` holds the k and v of the
    encoder's output.
    ctx: cache capacity (>= prefix + prompt length); defaults to that
    length.
    length: count of REAL prompt tokens when ``tokens`` is right-padded to
    a bucket (serving-engine bucketed prefill), an int or a 0-d integer
    tensor on the model's device.  The logits are then taken at the last
    real position and the caches (KV and recurrent state) are masked so
    they equal an unpadded prefill of ``length`` tokens.  An int becomes
    such a tensor, so both take one path; it reads no value back to the
    host, so one CUDA graph per bucket serves every length in it.  None =
    every token is real."""
    x, n_front = _embed_inputs(params, cfg, tokens, frontend_emb)
    bsz, s_tot = x.shape[:2]
    ctx = max(ctx or s_tot, s_tot)   # the prefix counts toward the capacity
    # the prefix is always real: the valid positions are [0, n_front+length)
    valid = None if length is None else torch.as_tensor(
        length, dtype=torch.int32, device=x.device) + n_front
    positions = _positions(x)
    enc = _encoded(params, cfg, frontend_emb, impl)
    unit_kinds, reps, tail_kinds = layer_plan(cfg)
    cache = _empty(cache_template(cfg, bsz, ctx), x.device)

    def unit_body(i, x):
        return _apply_unit_seq_exact(
            _layer(params["stack"], i), _layer(cache["stack"], i), x, cfg=cfg,
            kinds=unit_kinds, positions=positions, impl=impl, enc=enc,
            ctx=ctx, length=valid)

    x = fori_loop(0, reps, unit_body, x)
    if tail_kinds:
        x = _apply_unit_seq_exact(params["tail"], cache["tail"], x, cfg=cfg,
                                  kinds=tail_kinds, positions=positions,
                                  impl=impl, enc=enc, ctx=ctx, length=valid)
    if valid is None:
        return _logits(params, x[:, -1:], cfg), cache
    # the last real position, by a gather (JAX: a dynamic slice)
    last = (valid.to(torch.long) - 1).clamp(0, s_tot - 1)
    x_last = x.gather(1, last.expand(bsz, 1, x.shape[-1]))
    return _logits(params, x_last, cfg), cache


def decode_step(params, cache, tokens, pos, *, cfg: ModelConfig, impl=None):
    """One decode step.  tokens: [B, 1] int; pos: [B] int absolute
    position of this token.  Writes the token's k/v (or the recurrent
    state) into ``cache`` in place; returns (logits [B, 1, V], cache)."""
    x = _embed(params, cfg, tokens)
    unit_kinds, reps, tail_kinds = layer_plan(cfg)

    def unit_body(i, x):
        return _apply_unit_decode(_layer(params["stack"], i),
                                  _layer(cache["stack"], i), x, cfg=cfg,
                                  kinds=unit_kinds, pos=pos, impl=impl)

    x = fori_loop(0, reps, unit_body, x)
    if tail_kinds:
        x = _apply_unit_decode(params["tail"], cache["tail"], x, cfg=cfg,
                               kinds=tail_kinds, pos=pos, impl=impl)
    return _logits(params, x, cfg), cache
