"""Model assembly: templates, full-sequence forward, prefill, decode — the
port of the JAX package's ``models/lm.py`` for decoders of attention, SSM
and RG-LRU layers, whose attention layers may carry a Mixture-of-Experts
FFN.

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
cache it is given and returns that same cache.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import ATTN, LOCAL_ATTN, RGLRU, SSM, ModelConfig
from repro_torch.core.loops import fori_loop
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.params import DTYPES, spec, stack_tree, tree_map


def _check_kind(kind: str) -> None:
    if kind not in (ATTN, LOCAL_ATTN, RGLRU, SSM):
        raise ValueError(f"unknown layer kind {kind!r}")


def _check_cfg(cfg: ModelConfig) -> None:
    if cfg.frontend != "none" or cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: frontends and encoders are not ported yet (the "
            "slice that ports the VLM and audio archs brings them)")
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
    if cfg.d_ff:
        t["ffn"] = (B.moe_template(cfg) if _moe_layer(cfg, kind)
                    else B.mlp_template(cfg))
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
    window = cfg.attn_window if kind == LOCAL_ATTN else 0
    return {"attn": B.attn_cache_template(cfg, batch, ctx, window=window)}


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
def _apply_unit_seq(unit_params, x, *, cfg, kinds, positions, impl):
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
        if cfg.d_ff:
            x = _ffn(p, x, cfg=cfg, kind=kind, impl=impl)
    return x


def _apply_unit_seq_exact(unit_params, unit_cache, x, *, cfg, kinds,
                          positions, impl, ctx, length=None):
    """Like :func:`_apply_unit_seq`, and writes the caches into
    ``unit_cache``.  ``length``: positions >= length are right-padding
    (bucketed prefill); attention is exact under the causal mask, so the
    padding only has to be masked out of the KV caches and the recurrent
    state updates."""
    for i, kind in enumerate(kinds):
        p = unit_params[f"l{i}"]
        if kind == RGLRU:
            x, c = B.rglru_apply(p["rglru"], x, cfg=cfg, impl=impl,
                                 length=length)
        elif kind == SSM:
            x, c = B.ssm_apply(p["ssm"], x, cfg=cfg, impl=impl, length=length)
        else:
            window = _window(cfg, kind)
            x, (k, v) = B.attn_apply(p["attn"], x, cfg=cfg,
                                     positions=positions, impl=impl,
                                     causal=True, window=window,
                                     return_kv=True)
            c = B.attn_prefill_cache(k, v, positions=positions, window=window,
                                     ctx=ctx, length=length)
        (dsts,) = unit_cache[f"l{i}"].values()     # the one block cache
        for name, dst in dsts.items():
            dst.copy_(c[name])
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
        if cfg.d_ff:
            x = _ffn(p, x, cfg=cfg, kind=kind, impl=impl)
    return x


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------
def _embed_inputs(params, cfg: ModelConfig, tokens):
    # bf16 table row times a Python float stays bf16, as in JAX
    x = L.embed(tokens, params["embed"]) * math.sqrt(cfg.d_model)
    return x.to(DTYPES[cfg.dtype])


def _positions(x) -> torch.Tensor:
    bsz, s = x.shape[:2]
    return torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(
        bsz, s)


def _logits(params, x, cfg: ModelConfig):
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.unembed(x, table, cfg.tie_embeddings)


def forward(params, tokens, *, cfg: ModelConfig, impl=None):
    """Training/scoring forward.  tokens: [B, S] int.  Returns float32
    logits [B, S, vocab]."""
    x = _embed_inputs(params, cfg, tokens)
    positions = _positions(x)
    unit_kinds, reps, tail_kinds = layer_plan(cfg)

    def unit_body(i, x):
        return _apply_unit_seq(_layer(params["stack"], i), x, cfg=cfg,
                               kinds=unit_kinds, positions=positions,
                               impl=impl)

    x = fori_loop(0, reps, unit_body, x)
    if tail_kinds:
        x = _apply_unit_seq(params["tail"], x, cfg=cfg, kinds=tail_kinds,
                            positions=positions, impl=impl)
    return _logits(params, x, cfg)


def prefill(params, tokens, *, cfg: ModelConfig, impl=None,
            ctx: Optional[int] = None, length: Optional[int] = None):
    """Prefill: forward + exact KV caches.  Returns (logits_last [B, 1, V],
    cache).

    ctx: cache capacity (>= prompt length); defaults to the prompt length.
    length: count of REAL prompt tokens when ``tokens`` is right-padded to
    a bucket (serving-engine bucketed prefill), an int or a 0-d integer
    tensor on the model's device.  The logits are then taken at the last
    real position and the caches (KV and recurrent state) are masked so
    they equal an unpadded prefill of ``length`` tokens.  An int becomes
    such a tensor, so both take one path; it reads no value back to the
    host, so one CUDA graph per bucket serves every length in it.  None =
    every token is real."""
    x = _embed_inputs(params, cfg, tokens)
    bsz, s_tot = x.shape[:2]
    ctx = max(ctx or s_tot, s_tot)
    valid = None if length is None else torch.as_tensor(
        length, dtype=torch.int32, device=x.device)
    positions = _positions(x)
    unit_kinds, reps, tail_kinds = layer_plan(cfg)
    cache = _empty(cache_template(cfg, bsz, ctx), x.device)

    def unit_body(i, x):
        return _apply_unit_seq_exact(
            _layer(params["stack"], i), _layer(cache["stack"], i), x, cfg=cfg,
            kinds=unit_kinds, positions=positions, impl=impl, ctx=ctx,
            length=valid)

    x = fori_loop(0, reps, unit_body, x)
    if tail_kinds:
        x = _apply_unit_seq_exact(params["tail"], cache["tail"], x, cfg=cfg,
                                  kinds=tail_kinds, positions=positions,
                                  impl=impl, ctx=ctx, length=valid)
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
    x = _embed_inputs(params, cfg, tokens)
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
