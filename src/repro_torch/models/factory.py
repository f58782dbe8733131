"""Model factory: per-arch entry points used by the tests, the planner's
LM program and the serving engine — the port of the JAX package's
``models/factory.py``, the dry-run's abstract inputs included (meta
tensors: shapes and types, no storage).

The frontend archs take a second input beside the tokens, under the JAX
batch's key: paligemma-3b's ``patches`` (stubbed SigLIP patch embeddings,
prepended to the tokens) and whisper-small's ``frames`` (mel frames, fed to
its conv stem and encoder).  NumPy has no bfloat16, so the port's host
arrays are float32 holding bf16 values; the models cast them on the
device, so a float32 array of JAX's bf16 draw gives the same inputs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.regions import Impl
from repro_torch.models import lm
from repro_torch.models import params as P
from repro_torch.models.params import DTYPES
from repro_torch.optim.quantize import dequantize_params


# ---------------------------------------------------------------------------
# Default impl (offload pattern) per config
# ---------------------------------------------------------------------------
def default_impl(cfg: ModelConfig) -> Impl:
    """Architectural defaults (NOT planner decisions), as in the JAX
    package: MoE configs use the group-local expert-choice dispatch
    (``moe_ffn="offload"``; the token-choice one-hot path materializes a
    [T, E, C] tensor and is selected explicitly with
    ``Impl({"moe_ffn": "ref"})``); SSM archs use the time-sequential
    chunked scan."""
    imp = Impl()
    if cfg.is_moe:
        imp["moe_ffn"] = "offload"
    if cfg.family == "ssm":
        imp["ssm_scan"] = "seq"
    return imp


# ---------------------------------------------------------------------------
# Templates / init
# ---------------------------------------------------------------------------
def template(cfg: ModelConfig) -> dict:
    return lm.model_template(cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator):
    """Parameters drawn from ``generator``, on its device."""
    return P.init(template(cfg), generator)


def init_cache(cfg: ModelConfig, batch: int, ctx: int, device=None):
    """An empty cache (zeros, every slot_pos -1) on ``device`` (default
    ``cuda``)."""
    return P.init(lm.cache_template(cfg, batch, ctx),
                  torch.Generator(device=resolve_device(device)))


def _meta(template):
    return P.tree_map(lambda s: torch.empty(s.shape, dtype=DTYPES[s.dtype],
                                            device="meta"), template)


def abstract_params(cfg: ModelConfig):
    """The parameter tree as meta tensors."""
    return _meta(template(cfg))


def abstract_cache(cfg: ModelConfig, batch: int, ctx: int):
    """The cache tree as meta tensors."""
    return _meta(lm.cache_template(cfg, batch, ctx))


# ---------------------------------------------------------------------------
# Input specs (dry-run stand-ins: meta tensors, no allocation)
# ---------------------------------------------------------------------------
def meta_tensor(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_spec(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    spec = {"tokens": meta_tensor((b, s), torch.int32)}
    key = frontend_key(cfg)
    if key is not None:
        spec[key] = meta_tensor((b, cfg.frontend_seq, cfg.frontend_dim),
                                 torch.bfloat16)
    return spec


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Inputs for the step function of this cell (excluding params/opt/cache,
    which have their own abstract builders)."""
    if shape.kind in ("train", "prefill"):
        return {"batch": batch_spec(cfg, shape)}
    b = shape.global_batch          # decode: one new token a sequence
    return {"tokens": meta_tensor((b, 1), torch.int32),
            "pos": meta_tensor((b,), torch.int32)}


# ---------------------------------------------------------------------------
# Synthetic requests (smoke tests / drivers)
# ---------------------------------------------------------------------------
def frontend_key(cfg: ModelConfig) -> Optional[str]:
    """The batch key of the arch's frontend input: ``"patches"``,
    ``"frames"`` or None."""
    return {"siglip_stub": "patches",
            "audio_stub": "frames"}.get(cfg.frontend)


def bf16_values(a: np.ndarray) -> np.ndarray:
    """float32 ``a`` rounded to the nearest bf16 values (kept float32)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16).float().numpy()


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int,
                    seed: int = 0) -> dict:
    """``{"tokens": int32 [batch, seq]}`` drawn from NumPy's generator
    seeded with ``seed`` (host arrays: the engine takes NumPy prompts),
    and a frontend arch's standard-normal ``patches`` or ``frames``
    [batch, frontend_seq, frontend_dim] (float32 holding bf16 values)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq),
                                  dtype=np.int32)}
    key = frontend_key(cfg)
    if key is not None:
        out[key] = bf16_values(rng.standard_normal(
            (batch, cfg.frontend_seq, cfg.frontend_dim), dtype=np.float32))
    return out


def synthetic_request(cfg: ModelConfig, seq: int, seed: int = 0):
    """One serving request: (tokens [seq] int32, frontend [S_f, D_f] or
    None) — the shapes ``ServeEngine.submit`` takes."""
    b = synthetic_batch(cfg, 1, seq, seed)
    key = frontend_key(cfg)
    return b["tokens"][0], None if key is None else b[key][0]


def _frontend(batch: dict):
    return batch.get("patches", batch.get("frames"))


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------
def _merged(cfg: ModelConfig, impl: Optional[Impl]) -> Impl:
    return impl if impl is not None else default_impl(cfg)


def make_forward(cfg: ModelConfig, impl: Optional[Impl] = None,
                 remat: str = "none"):
    impl = _merged(cfg, impl)

    def fwd(params, batch):
        return lm.forward(params, batch["tokens"], cfg=cfg, impl=impl,
                          frontend_emb=_frontend(batch), remat=remat)
    return fwd


def make_loss(cfg: ModelConfig, impl: Optional[Impl] = None,
              remat: str = "none"):
    """``loss(params, batch)``: next-token cross-entropy under ``impl``
    (default :func:`default_impl`, whose regions all have a backward; a
    ``hopper`` kernel refuses inputs that require grad)."""
    impl = _merged(cfg, impl)

    def loss(params, batch):
        return lm.loss_fn(params, batch, cfg=cfg, impl=impl, remat=remat)
    return loss


def make_prefill_step(cfg: ModelConfig, impl: Optional[Impl] = None,
                      ctx: Optional[int] = None):
    impl = _merged(cfg, impl)

    def prefill_step(params, batch):
        return lm.prefill(params, batch["tokens"], cfg=cfg, impl=impl,
                          frontend_emb=_frontend(batch), ctx=ctx)
    return prefill_step


# ---------------------------------------------------------------------------
# Bucketed prefill (serving engine)
# ---------------------------------------------------------------------------
PREFILL_BUCKET_MIN = 8      # smallest padded prompt length


def prefill_bucket(n: int, max_len: int,
                   min_bucket: int = PREFILL_BUCKET_MIN) -> int:
    """Padded length for an ``n``-token prompt: the smallest power of two
    >= n (floored at ``min_bucket``), capped at ``max_len`` (cache capacity
    minus any frontend prefix) — so a bucket need not be a power of two."""
    if n > max_len:
        raise ValueError(f"prompt length {n} exceeds bucket cap {max_len}")
    b = max(min_bucket, 1 << max(n - 1, 0).bit_length())
    return min(b, max_len)


def make_bucketed_prefill_step(cfg: ModelConfig, impl: Optional[Impl] = None,
                               ctx: Optional[int] = None):
    """Prefill over right-padded prompts: ``(params, batch, length)`` where
    batch['tokens'] is [B, bucket] and ``length`` the count of real tokens,
    an int or a 0-d int32 tensor on the model's device (the serving
    engine's graphs feed a tensor, as the JAX engine feeds a traced
    scalar); logits and caches are exact for the real tokens.  A frontend
    rides in the batch as in :func:`make_forward`; ``ctx`` must hold the
    patch prefix too."""
    impl = _merged(cfg, impl)

    def prefill_step(params, batch, length):
        return lm.prefill(params, batch["tokens"], cfg=cfg, impl=impl,
                          frontend_emb=_frontend(batch), ctx=ctx,
                          length=length)
    return prefill_step


def make_serve_step(cfg: ModelConfig, impl: Optional[Impl] = None):
    impl = _merged(cfg, impl)

    def serve_step(params, cache, tokens, pos):
        return lm.decode_step(params, cache, tokens, pos, cfg=cfg, impl=impl)
    return serve_step


def dequantize_outside_stack(qparams, cfg: ModelConfig) -> dict:
    """A quantized tree with every leaf outside the layer stack dequantized
    to the model's type; the stacked leaves stay int8, for ``lm`` to
    dequantize one layer at a time where it uses them."""
    dt = DTYPES[cfg.dtype]
    return {k: v if k == "stack" else dequantize_params(v, default_dtype=dt)
            for k, v in qparams.items()}


def make_quantized_serve_step(cfg: ModelConfig, impl: Optional[Impl] = None):
    """Decode step over int8-quantized weights (``optim/quantize.py``).

    The JAX step dequantizes the whole tree at its top and XLA fuses each
    convert into the consuming product.  Here the leaves outside the layer
    stack are dequantized at the top of the step and each stacked leaf
    where its layer uses it (``lm._layer``), with the same values, so no
    dequantized stacked leaf is ever whole on the card."""
    impl = _merged(cfg, impl)

    def serve_step(qparams, cache, tokens, pos):
        return lm.decode_step(dequantize_outside_stack(qparams, cfg), cache,
                              tokens, pos, cfg=cfg, impl=impl)
    return serve_step
