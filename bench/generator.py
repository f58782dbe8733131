"""The one traffic generator: a mix's parameter file and a seed in, a
schedule of requests out.

Every seed gets the same schedule: prompt lengths, output lengths and
inter-arrival gaps are the quantiles (i + 0.5) / n of their
distributions, put in one order drawn once (``ORDER_SEED``); the seed
draws the prompts' token ids.  So two seeds do the same work on other
inputs.

Two kinds of mix:

* ``open_loop``: arrivals at ``rate_rps`` with exponential gaps (Poisson).
  The window's requests are the ``round(rate * seconds)`` that fall due in
  [0, seconds); ``tail_s`` seconds more of arrivals, drawn the same way,
  keep the load on while the last window requests finish.
* ``offline``: ``requests`` requests, all due when the window opens.
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

_NORMAL = NormalDist()
# The order of the lengths and gaps is drawn once, the same for every
# seed: near its knee a queue's tail swings with which long requests
# arrive together (on an H100, nemo12b.chat at 4 requests/s read a p90
# TTFT of 161-807 ms over nine seeds that reordered them), so a seed
# that reordered them would change the work.
ORDER_SEED = 0x0bde5


@dataclass
class Planned:
    """One request of the schedule."""
    due_s: float            # seconds after the window opens
    prompt: np.ndarray      # int32 token ids
    max_new_tokens: int
    in_window: bool         # due in [0, seconds): measured


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def lengths(dist: dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles of ``dist``, clipped to
    [min, max]."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    z = np.array([_NORMAL.inv_cdf(u) for u in _quantiles(n)])
    x = np.rint(dist["median"] * np.exp(dist["sigma"] * z))
    return np.clip(x, dist["min"], dist["max"]).astype(np.int64)


def exponential_gaps(rate: float, n: int) -> np.ndarray:
    return -np.log1p(-_quantiles(n)) / rate


def _requests(mix: dict, n: int, order: np.random.Generator,
              tokens: np.random.Generator,
              vocab: int) -> list[tuple[np.ndarray, int]]:
    prompts = order.permutation(lengths(mix["prompt"], n))
    outputs = order.permutation(lengths(mix["output"], n))
    return [(tokens.integers(0, vocab, int(p), dtype=np.int32), int(o))
            for p, o in zip(prompts, outputs)]


def _arrivals(rate: float, n: int, span: float,
              rng: np.random.Generator) -> np.ndarray:
    """``n`` due times in [0, span): the permuted gaps, scaled so that one
    more mean gap would reach ``span``."""
    gaps = rng.permutation(exponential_gaps(rate, n))
    due = np.cumsum(gaps) - gaps[0]
    return due * span / (due[-1] + 1.0 / rate) if n > 1 else due


def schedule(mix: dict, seed: int, seconds: float, vocab: int) -> list[Planned]:
    """The requests of one run, ordered by due time."""
    order = np.random.default_rng(ORDER_SEED)
    tokens = np.random.default_rng([seed, 0x5eed])
    if mix["kind"] == "offline":
        reqs = _requests(mix, int(mix["requests"]), order, tokens, vocab)
        return [Planned(0.0, p, o, True) for p, o in reqs]
    if mix["kind"] != "open_loop":
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    rate = float(mix["rate_rps"])
    out: list[Planned] = []
    for t0, span, measured in ((0.0, seconds, True),
                               (seconds, float(mix.get("tail_s", 0)), False)):
        n = int(round(rate * span))
        if n <= 0:
            continue
        reqs = _requests(mix, n, order, tokens, vocab)
        for due, (p, o) in zip(_arrivals(rate, n, span, order), reqs):
            out.append(Planned(t0 + float(due), p, o, measured))
    return out


def describe(mix: dict, plan: list[Planned]) -> str:
    win = [p for p in plan if p.in_window]
    pl = np.array([p.prompt.size for p in win])
    ol = np.array([p.max_new_tokens for p in win])
    return (f"{len(win)} requests in the window ({len(plan) - len(win)} after "
            f"it); prompt tokens median {np.median(pl):.0f} mean {pl.mean():.1f}"
            f" max {pl.max()}; output tokens median {np.median(ol):.0f} mean "
            f"{ol.mean():.1f} max {ol.max()}; total {int(pl.sum())} prompt + "
            f"{int(ol.sum())} output")
