"""Reductions the metric readers share: percentiles over a window's
records, and the model FLOPs of a tick."""
from __future__ import annotations

import math

import numpy as np

from bench import counts


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (linear between order statistics, as
    ``numpy.percentile``); infinite values stand for missing ones and sort
    last."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if v.size == 0:
        return math.nan
    pos = (v.size - 1) * q / 100.0
    lo, hi = int(math.floor(pos)), int(math.ceil(pos))
    if lo == hi or v[hi] == v[lo]:
        return float(v[lo])
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


def ttfts(win) -> list[float]:
    """Seconds from each measured request's due time to its first token;
    one that never got it (refused, failed, unfinished) is infinite."""
    return [s.times[0] - s.due if s.times else math.inf
            for s in win.measured()] + [math.inf] * win.refused


def token_gaps(win) -> list[float]:
    """Seconds since the same request's previous token, for every token of
    the window after a request's first."""
    out = []
    for s in win.served:
        t = s.times
        out += [b - a for a, b in zip(t, t[1:]) if win.in_window(b)]
    return out


def tick_flops(m: counts.Dims, tick) -> int:
    return (sum(counts.prefill_flops(m, n) for n in tick.admitted)
            + sum(counts.decode_flops(m, a) for a in tick.decoded))
