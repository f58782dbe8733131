"""``fori_loop`` — the port's stand-in for ``jax.lax.fori_loop``.

Every loop-faithful ``ref`` variant writes its C loop with :func:`fori_loop`,
so the loop stays visible to the planner's analysis:

* run normally, it is a plain Python loop;
* under a loop observer (the Step-1/Step-2 counting pass of
  ``core/intensity.py``), it runs the body **once**, at index ``lo``, and
  hands the trip count to the observer, which scales that iteration's
  counts and records one loop statement — what the JAX walker does with a
  ``scan`` body.  Without this, analysing MRI-Q's checksum loop at the
  paper size would execute 262,144 scalar iterations.

The observer is held in a context variable, so concurrent analyses in other
threads never see each other's counter.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable

_OBSERVER: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_loop_observer", default=None)


@contextlib.contextmanager
def observe_loops(observer):
    """Route every :func:`fori_loop` in the block to
    ``observer.loop(trip, run_once)``."""
    token = _OBSERVER.set(observer)
    try:
        yield observer
    finally:
        _OBSERVER.reset(token)


def fori_loop(lo: int, hi: int, body: Callable[[int, Any], Any], init):
    """``val = body(i, val)`` for ``i`` in ``[lo, hi)``; returns ``val``."""
    observer = _OBSERVER.get()
    if observer is not None:
        return observer.loop(max(hi - lo, 0), lambda: body(lo, init))
    val = init
    for i in range(lo, hi):
        val = body(i, val)
    return val
