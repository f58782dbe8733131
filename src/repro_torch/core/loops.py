"""``fori_loop`` — the port's stand-in for ``jax.lax.fori_loop``.

Every loop-faithful ``ref`` variant writes its C loop with :func:`fori_loop`,
so the loop stays visible to the planner's analysis:

* run normally, it is a plain Python loop;
* under a loop observer (the Step-1/Step-2 counting pass of
  ``core/intensity.py``), it runs the body **once**, at index ``lo``, and
  hands the trip count to the observer, which scales that iteration's
  counts and records one loop statement — what the JAX walker does with a
  ``scan`` body.  Without this, analysing MRI-Q's checksum loop at the
  paper size would execute 262,144 scalar iterations;
* under a loop capture (the static extraction of ``core/extract.py``), it
  runs **every** iteration, announcing each one to the capture
  (``capture.open_loop(trip)`` once, then ``capture.iteration(stmt, k)``
  around the body run of the k-th iteration), so the captured graph
  replays as it stands and each of its nodes can be tagged with its loop
  statement, iteration and trip count.  Every iteration is kept because
  the bodies index with Python ints: one iteration's graph cannot stand in
  for another's.

The observer and the capture are held in context variables, so concurrent
analyses in other threads never see each other's.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable

_OBSERVER: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_loop_observer", default=None)
_CAPTURE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_loop_capture", default=None)


@contextlib.contextmanager
def observe_loops(observer):
    """Route every :func:`fori_loop` in the block to
    ``observer.loop(trip, run_once)``."""
    token = _OBSERVER.set(observer)
    try:
        yield observer
    finally:
        _OBSERVER.reset(token)


def loop_observer():
    """The counting observer of the enclosing :func:`observe_loops`, or
    None: a program that has no ``fori_loop`` left to run (a captured
    graph) announces its loop statements to it itself."""
    return _OBSERVER.get()


@contextlib.contextmanager
def capture_loops(capture):
    """Announce every :func:`fori_loop` in the block to ``capture`` (see
    the module docstring); the counting observer, when one is set, still
    takes precedence."""
    token = _CAPTURE.set(capture)
    try:
        yield capture
    finally:
        _CAPTURE.reset(token)


def fori_loop(lo: int, hi: int, body: Callable[[int, Any], Any], init):
    """``val = body(i, val)`` for ``i`` in ``[lo, hi)``; returns ``val``."""
    observer = _OBSERVER.get()
    if observer is not None:
        return observer.loop(max(hi - lo, 0), lambda: body(lo, init))
    capture = _CAPTURE.get()
    if capture is not None:
        stmt = capture.open_loop(max(hi - lo, 0))
        val = init
        for i in range(lo, hi):
            with capture.iteration(stmt, i - lo):
                val = body(i, val)
        return val
    val = init
    for i in range(lo, hi):
        val = body(i, val)
    return val
