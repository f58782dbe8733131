"""Pluggable token sampling for the serving engine — the port of the JAX
package's ``serving/sampling.py``.

Greedy / temperature / top-k, applied identically at the first token and
at every decode step.  Determinism contract: the sampled token is a
function of (engine seed, request id, step index, logits row) alone — each
sampled row draws from a ``torch.Generator`` seeded from
(seed, rid, step) — so a request samples the same tokens whatever slot it
lands in and whatever else is interleaved with it.  The generators are not
``jax.random``'s: tokens sampled at a temperature differ from the JAX
package's; greedy tokens do not.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs.

    temperature: 0 = greedy (argmax); > 0 = softmax sampling at that
    temperature.  top_k: 0 = full vocabulary; k > 0 restricts sampling to
    the k highest-logit tokens (ignored under greedy)."""
    temperature: float = 0.0
    top_k: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")


GREEDY = SamplingParams()


def _row_seed(seed: int, rid: int, step: int) -> int:
    """A 63-bit generator seed that depends on (seed, rid, step) only."""
    state = np.random.SeedSequence([seed, rid, step]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def make_sampler(seed: int):
    """Returns ``sample(logits, rids, steps, temps, top_ks)`` -> int32 tokens
    [B] (a host NumPy array); ``logits`` is [B, V] on any device, the
    per-request knobs are sequences of length B."""

    def sample(logits: torch.Tensor, rids, steps, temps, top_ks) -> np.ndarray:
        lg = logits.float()
        out = lg.argmax(dim=-1).to(torch.int32).cpu().numpy()
        for i, (rid, step, temp, top_k) in enumerate(
                zip(rids, steps, temps, top_ks)):
            if temp <= 0.0:
                continue
            row = lg[i]
            if top_k > 0:
                # top-k as a threshold mask: the k-th largest logit
                kth = torch.topk(row, min(int(top_k), row.shape[-1])).values[-1]
                row = torch.where(row < kth, -torch.inf, row)
            probs = torch.softmax(row / max(float(temp), 1e-6), dim=-1)
            gen = torch.Generator(device=row.device).manual_seed(
                _row_seed(seed, int(rid), int(step)))
            out[i] = int(torch.multinomial(probs, 1, generator=gen))
        return out

    return sample
