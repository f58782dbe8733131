"""One call captured into a CUDA graph, shared by the two places that
capture: Step 4's measurement of a pattern (``core/search.py``) and the
serving engine's steps (``serving/graphs.py``).

:func:`capture` records ``fn(*args)`` into a graph object with the
``torch.cuda.CUDAGraph`` interface (``capture_begin``, ``capture_end``,
``replay``, ``reset``):

* **One capture at a time**, in ``thread_local`` capture mode: another
  thread may go on replaying graphs and copying to and from the device
  meanwhile (the engine ticks while the online replanner measures and
  captures on its own thread).  A host sync anywhere in ``fn``
  (``.item()``, ``int()`` of a tensor, ``.cpu()``, a Python branch on a
  tensor value) fails the capture, so the capture is the check that the
  call has none.
* **Garbage collection is held off** during a capture: collecting an
  unreachable graph destroys it (``cudaGraphExecDestroy``), which a capture
  in progress does not survive.  Collect first, as ``torch.cuda.graph``
  does, then hold off collection until the capture has ended.
* **Launch counters.**  Each kernel wrapper adds one to its ``launches``
  where it launches.  Under a capture that line runs once and no kernel
  executes, so :func:`capture` takes each counter's delta over the capture
  back and returns it; :class:`GraphCall` (or any caller that replays)
  adds it at every replay with :func:`add_launches`, so the counters go on
  counting kernel executions.  A replay on another thread while a capture
  is in progress holds its additions back until the capture has taken its
  delta back, so neither is lost.

A capture that raises leaves the graph unusable; its error propagates
(there is no eager fallback): the caller decides what a failed capture
means.
"""
from __future__ import annotations

import contextlib
import gc
import threading

import torch

from repro_torch.kernels import launch_counters

_CAPTURE_LOCK = threading.Lock()      # one capture at a time
_COUNT_LOCK = threading.Lock()        # guards the two below
_capturing = [False]
_held: list = []                      # (counter, delta) of replays meanwhile


def add_launches(deltas) -> None:
    """Add one replay's ``(counter, delta)`` pairs to the counters (held
    back while a capture is taking its own delta)."""
    with _COUNT_LOCK:
        if _capturing[0]:
            _held.extend(deltas)
            return
        for counter, delta in deltas:
            counter.launches += delta


def capture(graph, fn, args, *, stream=None, pool=None) -> tuple:
    """Capture ``fn(*args)`` into ``graph`` on ``stream`` (a side stream;
    None: the current one) with memory from ``pool`` (None: a private pool
    of the graph's own).  Returns ``(outputs, deltas)``: the call's static
    outputs and the launch-counter deltas one replay adds."""
    counters = launch_counters()
    on_stream = (torch.cuda.stream(stream) if stream is not None
                 else contextlib.nullcontext())
    with _CAPTURE_LOCK:
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        with _COUNT_LOCK:
            _capturing[0] = True
            before = [c.launches for c in counters]
        try:
            with on_stream:
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    outputs = fn(*args)
                except BaseException:
                    # the call's own error is the one to report; ending an
                    # invalidated capture raises one of its own
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
        finally:
            if collecting:
                gc.enable()
            with _COUNT_LOCK:
                deltas = [(c, c.launches - b)
                          for c, b in zip(counters, before)
                          if c.launches != b]
                for c, b in zip(counters, before):
                    c.launches = b
                _capturing[0] = False
                held = list(_held)
                _held.clear()
            add_launches(held)
    return outputs, deltas


class GraphCall:
    """``fn(*args)`` captured once into ``graph`` (see :func:`capture`);
    :meth:`replay` runs it again on the current stream and returns the
    same static outputs, rewritten.  :meth:`release` drops the graph and
    its outputs, so the graph's pool is free once no other tensor holds
    its memory."""

    def __init__(self, graph, fn, args, *, stream=None, pool=None):
        self.graph = graph
        self.outputs, self.deltas = capture(graph, fn, args, stream=stream,
                                            pool=pool)

    def replay(self):
        self.graph.replay()
        add_launches(self.deltas)
        return self.outputs

    def release(self) -> None:
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.outputs = None
