"""Model factory: per-arch entry points used by the tests, the planner's
LM program and the serving engine — the port of the JAX package's
``models/factory.py`` (no dry-run specs, no quantized serving yet).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.regions import Impl
from repro_torch.models import lm
from repro_torch.models import params as P


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


# ---------------------------------------------------------------------------
# Synthetic requests (smoke tests / drivers)
# ---------------------------------------------------------------------------
def synthetic_batch(cfg: ModelConfig, batch: int, seq: int,
                    seed: int = 0) -> dict:
    """``{"tokens": int32 [batch, seq]}`` drawn from NumPy's generator
    seeded with ``seed`` (host arrays: the engine takes NumPy prompts)."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq),
                                   dtype=np.int32)}


def synthetic_request(cfg: ModelConfig, seq: int, seed: int = 0):
    """One serving request: (tokens [seq] int32, frontend or None) — the
    shapes ``ServeEngine.submit`` takes."""
    return synthetic_batch(cfg, 1, seq, seed)["tokens"][0], None


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------
def _merged(cfg: ModelConfig, impl: Optional[Impl]) -> Impl:
    return impl if impl is not None else default_impl(cfg)


def make_forward(cfg: ModelConfig, impl: Optional[Impl] = None):
    impl = _merged(cfg, impl)

    def fwd(params, batch):
        return lm.forward(params, batch["tokens"], cfg=cfg, impl=impl)
    return fwd


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
    scalar); logits and caches are exact for the real tokens."""
    impl = _merged(cfg, impl)

    def prefill_step(params, batch, length):
        return lm.prefill(params, batch["tokens"], cfg=cfg, impl=impl,
                          ctx=ctx, length=length)
    return prefill_step


def make_serve_step(cfg: ModelConfig, impl: Optional[Impl] = None):
    impl = _merged(cfg, impl)

    def serve_step(params, cache, tokens, pos):
        return lm.decode_step(params, cache, tokens, pos, cfg=cfg, impl=impl)
    return serve_step
