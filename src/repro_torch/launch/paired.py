"""Rule P: how the timing twins compare the timings of two plans.

``launch/verification.py`` and ``launch/autotune.py`` judge two plans'
winners against each other: the serial, pipelined and warm plans must
select the same pattern, and the tuned winner must be no slower than the
fixed one.  Each plan measures on its own: a plan is never handed another
plan's medians.  The JAX benchmarks' one retry of the pair of plans stays.
When a comparison still fails after the retry, the two winning patterns A
and B are re-timed paired (:func:`retime`):

1. each is built once, from one program instance, on one sample input;
2. each is warmed with one call;
3. 5 rounds of A, B, B, A follow, every call timed on its own: on a card
   with CUDA events after a ``torch.cuda.synchronize()``, on the CPU with
   the host clock;
4. the statistic is the median over the rounds of (B1 + B2) / (A1 + A2).

"Same winner" passes when the statistic lies within [1/1.05, 1.05] (the two
winners tie within noise, :func:`ties`); "B no slower than A x 1.05" passes
when it is at most 1.05 (:func:`no_slower`).  1.05 is the JAX autotune
benchmark's own tolerance; no other bound is used.  What is deterministic
(measured sequences, counts, search spaces, quarantine, rollbacks) is never
re-timed: it stays a hard assertion.  Each row records what decided it,
``"decided_by": "plan" | "retry" | "paired"``, and ``"paired_ratio"`` when
the paired re-time ran.
"""
from __future__ import annotations

import time
from statistics import median
from typing import Callable

import torch

from repro_torch.core.regions import Impl
from repro_torch.core.search import compile_pattern, pattern_sources

TIE = 1.05
ROUNDS = 5


def ties(ratio: float) -> bool:
    """Two winners tie: the paired statistic within [1/TIE, TIE]."""
    return 1.0 / TIE <= ratio <= TIE


def no_slower(ratio: float) -> bool:
    """B (the statistic's numerator) is no slower than A x TIE."""
    return ratio <= TIE


def call_seconds(fn: Callable[[], object], device) -> float:
    """One call of ``fn``, timed on ``device``: CUDA events after a
    synchronize on a card, the host clock on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def paired_ratio(a: Callable[[], object], b: Callable[[], object], *,
                 timer: Callable[[Callable[[], object]], float],
                 rounds: int = ROUNDS) -> float:
    """The median over ``rounds`` rounds of A, B, B, A of (B1 + B2) /
    (A1 + A2), after one warm-up call of each; ``timer(fn)`` calls ``fn``
    once and returns its seconds."""
    a()
    b()
    ratios = []
    for _ in range(rounds):
        a1, b1, b2, a2 = timer(a), timer(b), timer(b), timer(a)
        ratios.append((b1 + b2) / (a1 + a2))
    return median(ratios)


def retime(program, impl_a, impl_b, *, seed: int = 0,
           rounds: int = ROUNDS) -> float:
    """Rule P's statistic for the patterns ``impl_a`` (A) and ``impl_b``
    (B) of ``program``, both built from this instance and run on one
    sample input on ``program.device``."""
    args = program.sample_inputs(seed, program.device)
    on_card = torch.device(program.device).type == "cuda"

    def built(impl):
        # the planner's compile step: the kernels' builds on a card only
        art = compile_pattern(lambda: program.build(Impl(dict(impl))),
                              pattern_sources(impl) if on_card else ())
        if not art.ok:
            raise RuntimeError(f"paired re-time: {Impl(dict(impl)).describe()}"
                               f": the pattern does not build: {art.error}")
        return lambda: art.fn(*args)

    return paired_ratio(built(impl_a), built(impl_b), rounds=rounds,
                        timer=lambda fn: call_seconds(fn, program.device))
