"""The system under test: the port's model configuration for a
configuration file, the engine that serves it, and its warm-up.

This is the one module of the harness that imports the program
(``repro_torch``, beside the JAX package under ``src/``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.models import factory as F
from repro_torch.serving.engine import ServeEngine

WARM_NEW_TOKENS = 2


def port_config(c: dict):
    """The port's ``ModelConfig`` of the configuration file ``c``: the
    registered architecture ``c["port_arch"]`` with the file's sizes."""
    heads = c["num_attention_heads"]
    experts = c.get("num_local_experts", 0)
    fields = dict(
        num_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        num_heads=heads, num_kv_heads=c["num_key_value_heads"],
        head_dim=c.get("head_dim") or c["hidden_size"] // heads,
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        num_experts=experts,
        experts_per_token=c.get("num_experts_per_tok", 0),
        moe_d_ff=c["intermediate_size"] if experts else 0,
        rope_theta=float(c["rope_theta"]), norm_eps=float(c["rms_norm_eps"]),
        tie_embeddings=bool(c["tie_word_embeddings"]),
        dtype=c["torch_dtype"])
    if "capacity_factor" in c:
        fields["capacity_factor"] = float(c["capacity_factor"])
    if c.get("sliding_window"):
        raise ValueError("sliding-window attention is not served here")
    return dataclasses.replace(get_config(c["port_arch"]), **fields)


def check_layout(cfg, params: dict) -> None:
    """The benchmark's weight tree has the port's leaves and shapes."""
    want = F.abstract_params(cfg)

    def walk(a, b, path):
        if isinstance(a, dict):
            if set(a) != set(b):
                raise ValueError(f"weights at {path}: {sorted(b)} where the "
                                 f"port has {sorted(a)}")
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
            raise ValueError(f"weights at {path}: {tuple(b.shape)} {b.dtype}"
                             f" where the port has {tuple(a.shape)} {a.dtype}")

    walk(want, params, "")


def engine(cfg, params: dict, mix: dict, config: dict, seed: int) -> ServeEngine:
    return ServeEngine(cfg, params, slots=int(mix["slots"]),
                       ctx=int(mix["ctx"]), seed=seed,
                       impl=dict(config["pattern"]))


def buckets(plan: list, ctx: int) -> list[int]:
    """The prefill buckets the schedule's prompts fall into."""
    return sorted({F.prefill_bucket(p.prompt.size, ctx) for p in plan})


def warm(eng: ServeEngine, bucket_list: list[int], vocab: int,
         seed: int) -> None:
    """Serve one short request a bucket through the engine's own entry
    points: every prefill graph of the cell's buckets and the decode graph
    are captured and replayed once, and the sampler's host buffers made,
    before the window opens."""
    rng = np.random.default_rng([seed, 0x3a53])
    for b in bucket_list:
        n = b // 2 + 1 if b & (b - 1) == 0 and b >= 16 else b - WARM_NEW_TOKENS
        if F.prefill_bucket(n, eng.ctx) != b:
            raise ValueError(f"no warm-up length falls into bucket {b}")
        eng.submit(rng.integers(0, vocab, n, dtype=np.int32),
                   max_new_tokens=WARM_NEW_TOKENS)
    eng.run_to_completion()
    eng.drain_finished()
