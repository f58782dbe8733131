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

For training, ``forward`` takes ``remat`` (the layer stack under
``torch.utils.checkpoint``, :func:`_run_stack`) and :func:`loss_fn` is the
train step's next-token cross-entropy.  A stacked leaf of an int8 tree
(``optim/quantize.py``) is dequantized where its layer uses it
(:func:`_layer`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ATTN, LOCAL_ATTN, RGLRU, SSM, ModelConfig
from repro_torch.core.loops import fori_loop
from repro_torch.core.regions import dispatch
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.params import DTYPES, spec, stack_tree, tree_map
from repro_torch.optim import quantize as Q
from repro_torch.parallel import ctx as PC
from repro_torch.parallel.ctx import constrain, gather_fsdp


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
    """Uninitialized cache leaves (under a mesh, each laid out by the
    rules, every rank allocating its block)."""
    return tree_map(lambda s: PC.empty(s.shape, DTYPES[s.dtype], s.axes,
                                       "cache", device), template)


def _layer(tree, i: int, dtype=None):
    """Views of layer ``i`` of a stacked tree.  A quantized leaf
    (``{"q", "scale"}``, ``optim/quantize.py``) is dequantized to ``dtype``
    here: layer ``i``'s slice of q times the scale all layers share, the
    values of JAX's whole-tree dequantization one layer at a time."""
    if Q.is_quantized(tree):
        return Q.dequantize_leaf({"q": tree["q"][i], "scale": tree["scale"]},
                                 dtype)
    if isinstance(tree, dict):
        return {k: _layer(v, i, dtype) for k, v in tree.items()}
    return tree[i]


def _weights(tree):
    """A weight tree as its layers use it: under a mesh with FSDP, each
    leaf's shards over the data axes gathered (ZeRO-3; the identity on
    one device)."""
    return tree_map(gather_fsdp, tree)


def _wlayer(tree, i: int, dtype):
    """:func:`_layer` of a stacked weight tree, gathered as :func:`_weights`."""
    return _weights(_layer(tree, i, dtype))


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
        # DTensor's convolution takes whole weights: an FSDP-sharded stem
        # is gathered here (the identity on one device)
        st = {k: constrain(w, (None,) * w.dim())
              for k, w in params["stem"].items()}
        x = frames.to(st["w1"].dtype)         # the conv takes one type
        x = dispatch("conv_stem", impl, x, st["w1"], st["b1"], stride=1)
        x = dispatch("conv_stem", impl, x.to(st["w2"].dtype), st["w2"],
                     st["b2"], stride=2)
        x = x.to(dt)
    else:
        w = gather_fsdp(params["w_front"])
        x = (frames.to(w.dtype) @ w).to(dt)
    positions = _positions(x)
    enc = params["encoder"]

    def body(i, x):
        p = _wlayer(enc["stack"], i, dt)
        x = B.attn_apply(p["attn"], x, cfg=cfg, positions=positions,
                         impl=impl, causal=False)
        return B.mlp_apply(p["ffn"], x, cfg=cfg, impl=impl)

    x = fori_loop(0, cfg.encoder_layers, body, x)
    return L.rms_norm(x, gather_fsdp(enc["ln"]), cfg.norm_eps)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------
def _embed(params, cfg: ModelConfig, tokens):
    # bf16 table row times a Python float stays bf16, as in JAX
    x = L.embed(tokens, gather_fsdp(params["embed"])) * math.sqrt(cfg.d_model)
    return x.to(DTYPES[cfg.dtype])


def _embed_inputs(params, cfg: ModelConfig, tokens, frontend_emb):
    """(x, n_front): the scaled token embeddings, behind the projected
    patch embeddings of a SigLIP-stub model when it is given them (the
    patches are not scaled by sqrt(d)).  n_front = prefix length."""
    x = _embed(params, cfg, tokens)
    if cfg.frontend != "siglip_stub" or frontend_emb is None:
        return x, 0
    w = gather_fsdp(params["w_front"])
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
    x = L.rms_norm(x, gather_fsdp(params["final_ln"]), cfg.norm_eps)
    table = gather_fsdp(params["embed"] if cfg.tie_embeddings
                        else params["unembed"])
    # batch -> data, vocab -> model: a product over an FSDP-sharded embed
    # dim is a partial sum until here
    return constrain(L.unembed(x, table, cfg.tie_embeddings),
                     ("batch", None, "vocab"))


# ---------------------------------------------------------------------------
# Rematerialization of the layer stack (training)
# ---------------------------------------------------------------------------
REMAT_MODES = ("none", "dots", "full", "2level")
# the products whose outputs the "dots" policy saves: matrix products with
# no batch dims (JAX: dots_with_no_batch_dims_saveable); a batched product
# (bmm, einsum over heads or experts) is recomputed like every other op
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpointed(body, i: int, x, *, dots: bool):
    """``body(i, x)`` under ``torch.utils.checkpoint``: saving only the
    unit's input (``dots=False``, JAX's plain ``jax.checkpoint``) or also
    its no-batch-dim products (``dots=True``)."""
    kw = {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                          _dots_policy)} if dots else {}
    return checkpoint(_under_mesh(body), i, x, use_reentrant=False, **kw)


def _under_mesh(body):
    """``body`` with the mesh's gather fallback back on when the backward
    rematerializes it (``parallel.ctx.reentered``; nothing on one
    device)."""
    def run(i, x):
        with PC.reentered():
            return body(i, x)
    return run


def _closest_divisor(n: int, target: int) -> int:
    best = 1
    for d in range(1, n + 1):
        if n % d == 0 and abs(d - target) < abs(best - target):
            best = d
    return best


def _run_stack(unit_body, reps: int, x, remat: str):
    """``unit_body`` over the ``reps`` units of the stack under ``remat``
    (JAX's ``_scan_stack`` / ``_maybe_remat``): ``"none"`` saves what
    autograd saves; ``"dots"`` checkpoints each unit saving its
    no-batch-dim products; ``"full"`` checkpoints each unit saving nothing
    inside it; ``"2level"`` splits the stack into G ~ sqrt(L) groups, each
    group checkpointed whole (only the G group inputs are kept) and its
    units on the dots policy inside.  The values are the same in every
    mode."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat {remat!r} not in {REMAT_MODES}")
    if remat == "none":
        return fori_loop(0, reps, unit_body, x)
    if remat != "2level":
        return fori_loop(0, reps, lambda i, x: _checkpointed(
            unit_body, i, x, dots=remat == "dots"), x)
    g = _closest_divisor(reps, int(math.sqrt(reps)) or 1)
    per = reps // g

    def group(j, x):
        return fori_loop(j * per, (j + 1) * per, lambda i, x: _checkpointed(
            unit_body, i, x, dots=True), x)

    return fori_loop(0, g, lambda j, x: _checkpointed(group, j, x, dots=False),
                     x)


def forward(params, tokens, *, cfg: ModelConfig, impl=None,
            frontend_emb=None, remat: str = "none"):
    """Training/scoring forward.  tokens: [B, S] int; ``frontend_emb``: a
    frontend model's patch embeddings [B, S_f, frontend_dim] (prepended;
    optional) or mel frames [B, S_frames, frontend_dim] (encoded;
    required).  ``remat``: how the layer stack is rematerialized for the
    backward (:func:`_run_stack`).  Returns float32 logits [B, S, vocab]
    of the token positions."""
    dt = DTYPES[cfg.dtype]
    x, n_front = _embed_inputs(params, cfg, tokens, frontend_emb)
    positions = _positions(x)
    enc = _encoded(params, cfg, frontend_emb, impl)
    unit_kinds, reps, tail_kinds = layer_plan(cfg)

    def unit_body(i, x):
        return _apply_unit_seq(_wlayer(params["stack"], i, dt), x, cfg=cfg,
                               kinds=unit_kinds, positions=positions,
                               impl=impl, enc=enc)

    x = _run_stack(unit_body, reps, x, remat)
    if tail_kinds:
        x = _apply_unit_seq(_weights(params["tail"]), x, cfg=cfg,
                            kinds=tail_kinds,
                            positions=positions, impl=impl, enc=enc)
    return _logits(params, x[:, n_front:], cfg)


def loss_fn(params, batch, *, cfg: ModelConfig, impl=None,
            remat: str = "none"):
    """Next-token cross-entropy (float32).  batch: {'tokens', optional
    'frames'/'patches'}."""
    tokens = batch["tokens"]
    logits = forward(params, tokens, cfg=cfg, impl=impl,
                     frontend_emb=batch.get("patches", batch.get("frames")),
                     remat=remat)
    labels = tokens[:, 1:].long()
    lg = logits[:, :-1].float()
    logz = constrain(torch.logsumexp(lg, dim=-1), ("batch", None))
    # a vocab-sharded gather is a masked partial sum: reduce it before the
    # index (constrain is the identity on one device)
    gold = constrain(torch.gather(lg, -1, labels[..., None]),
                     ("batch", None, None))[..., 0]
    return torch.mean(logz - gold)


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
    dt = DTYPES[cfg.dtype]
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
            _wlayer(params["stack"], i, dt), _layer(cache["stack"], i), x,
            cfg=cfg,
            kinds=unit_kinds, positions=positions, impl=impl, enc=enc,
            ctx=ctx, length=valid)

    x = fori_loop(0, reps, unit_body, x)
    if tail_kinds:
        x = _apply_unit_seq_exact(_weights(params["tail"]), cache["tail"], x,
                                  cfg=cfg,
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
    dt = DTYPES[cfg.dtype]
    x = _embed(params, cfg, tokens)
    unit_kinds, reps, tail_kinds = layer_plan(cfg)

    def unit_body(i, x):
        return _apply_unit_decode(_wlayer(params["stack"], i, dt),
                                  _layer(cache["stack"], i), x, cfg=cfg,
                                  kinds=unit_kinds, pos=pos, impl=impl)

    x = fori_loop(0, reps, unit_body, x)
    if tail_kinds:
        x = _apply_unit_decode(_weights(params["tail"]), cache["tail"], x,
                               cfg=cfg,
                               kinds=tail_kinds, pos=pos, impl=impl)
    return _logits(params, x, cfg), cache
