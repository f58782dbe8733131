"""One serving step captured once as a CUDA graph and then replayed — the
port's counterpart of the JAX engine's ``jax.jit`` of its bucketed prefill
and its batched decode step.

A :class:`StepGraph` holds one step function ``fn(*fixed, *fed)``.
``fixed`` are tensors whose storage stays put for the graph's life (the
parameters, the engine's live cache); ``fed`` are the per-call host inputs
(tokens, positions, a prompt length, a frontend's patch embeddings or mel
frames), NumPy arrays of fixed shapes.  So a frontend model's prefill is
one graph per (bucket, frontend shape), whisper's encoder inside it.

On a card, construction

1. warms ``fn`` eagerly on a side stream, on throwaway inputs: the example
   values of ``fed`` and ``warm_fixed`` (a template cache, say — warming on
   the live cache would advance in-flight requests' recurrent state and
   write their KV slots).  The warm-up also builds every kernel that
   ``nvcc`` has not built yet, so no build runs inside a capture;
2. captures one call on that side stream against ``fixed`` and static
   device buffers for ``fed``, in ``thread_local`` capture mode: another
   thread may go on replaying graphs and copying to and from the device
   meanwhile (the engine ticks while the online replanner prepares the
   next generation on its own thread).  One capture runs at a time.  A
   capture that fails raises: there is no eager fallback.  A host sync
   anywhere in the step (``.item()``, ``int()`` of a tensor, ``.cpu()``, a
   Python branch on a tensor value) fails the capture, so the capture is
   the check that the step has none.  Garbage collection is held off
   during a capture: collecting an unreachable graph destroys it, which a
   capture in progress does not survive.

A call copies the host inputs into pinned staging buffers, from there into
the static buffers (``non_blocking``), replays the graph and returns its
static outputs.  On the CPU a StepGraph is the eager step function
(:class:`EagerStep`), and its first call stands in for the capture.
``built`` says whether the step has been built (captured, or on the CPU
called once): the engine rolls back on a fault of a built step and lets a
build's fault propagate.

**Memory pool.**  The graphs of one plan generation share one pool
(``torch.cuda.graph_pool_handle()``): a later capture reuses the memory an
earlier graph used for its intermediates, so the pool is sized by the
largest step, not by the sum over every bucket.  The price: replaying
graph A rewrites A's intermediates, and a graph B captured after A may keep
its static outputs there.  So every graph's outputs (logits, the one-slot
prefill cache) must be read or copied before any other graph of the pool
replays.  ``ServeEngine`` keeps to that: it copies a prefill's cache into
the slot and samples its logits, and samples a decode's logits, before it
enqueues the next replay (stream order does the rest).  Each generation
has a pool of its own, so a generation captured on another thread while
the serving one replays is never handed memory a live replay is writing.

**Launch counters.**  Each kernel wrapper adds one to its ``launches``
where it launches.  Under a capture that line runs once and no kernel
executes, so a StepGraph takes each counter's delta over the capture back
and adds it at every replay: the counters go on counting kernel
executions.  A replay on another thread while a capture is in progress
holds its additions back until the capture has taken its delta back, so
neither is lost.
"""
from __future__ import annotations

import gc
import threading

import numpy as np
import torch

from repro_torch.kernels import launch_counters
from repro_torch.models.params import tree_leaves

_CAPTURE_LOCK = threading.Lock()      # one capture at a time
_COUNT_LOCK = threading.Lock()        # guards the two below
_capturing = [False]
_held: list = []                      # (counter, delta) of replays meanwhile


def _add_launches(deltas) -> None:
    with _COUNT_LOCK:
        if _capturing[0]:
            _held.extend(deltas)
            return
        for counter, delta in deltas:
            counter.launches += delta


class EagerStep:
    """``fn(*fixed, *fed)`` called eagerly, the fed host arrays moved to
    the fixed tensors' device first."""

    def __init__(self, fn, fixed: tuple):
        self.fn = fn
        self.fixed = tuple(fixed)
        # fixed: tensors and dict trees of them (the params, a cache)
        self.device = tree_leaves(dict(enumerate(self.fixed)))[0].device
        self.built = False               # the first call is the build

    def __call__(self, *fed: np.ndarray):
        out = self.fn(*self.fixed, *(
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in fed))
        self.built = True
        return out


class StepGraph(EagerStep):
    """``fn(*fixed, *fed)`` captured once as a CUDA graph (on a card) and
    replayed at every call; eager on the CPU.

    * ``feeds`` — name -> example NumPy array of each fed input, in call
      order; it fixes their shapes and types and is the warm-up's input.
    * ``warm_fixed`` — throwaway stand-ins for ``fixed`` during the
      warm-up (default: ``fixed``, for a step that writes none of them).
    * ``pool`` — the memory pool the graph shares (see the module
      docstring for the rule that makes sharing safe).
    """

    def __init__(self, fn, fixed: tuple, feeds: dict, *, warm_fixed=None,
                 pool=None):
        super().__init__(fn, fixed)
        self.graph = None
        if self.device.type != "cuda":
            return
        dev = self.device
        self._pinned = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                        for a in feeds.values()]
        self._static = [p.to(dev) for p in self._pinned]
        self._copied = torch.cuda.Event()
        with torch.cuda.device(dev):
            cur = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                fn(*(self.fixed if warm_fixed is None else warm_fixed),
                   *self._static)
            side.synchronize()
            counters = launch_counters()
            graph = torch.cuda.CUDAGraph()
            with _CAPTURE_LOCK:
                # no garbage collection inside a capture: a collected
                # graph's destructor (cudaGraphExecDestroy) invalidates it.
                # Collect first, as torch.cuda.graph does, then hold off
                # collection until the capture has ended
                gc.collect()
                collecting = gc.isenabled()
                gc.disable()
                with _COUNT_LOCK:
                    _capturing[0] = True
                    before = [c.launches for c in counters]
                try:
                    with torch.cuda.stream(side):
                        graph.capture_begin(pool=pool,
                                            capture_error_mode="thread_local")
                        try:
                            self.outputs = fn(*self.fixed, *self._static)
                        finally:
                            graph.capture_end()
                finally:
                    if collecting:
                        gc.enable()
                    with _COUNT_LOCK:
                        self.deltas = [(c, c.launches - b)
                                       for c, b in zip(counters, before)
                                       if c.launches != b]
                        for c, b in zip(counters, before):
                            c.launches = b
                        _capturing[0] = False
                        held = list(_held)
                        _held.clear()
                    _add_launches(held)
            # the replays run on the caller's stream: order them after the
            # warm-up's writes
            cur.wait_stream(side)
        self.graph = graph
        self.built = True

    def __call__(self, *fed: np.ndarray):
        if self.graph is None:
            return super().__call__(*fed)
        # the staging buffers are free once their last copies have run
        self._copied.synchronize()
        for a, pin, buf in zip(fed, self._pinned, self._static):
            pin.numpy()[...] = a
            buf.copy_(pin, non_blocking=True)
        self._copied.record()
        self.graph.replay()
        _add_launches(self.deltas)
        return self.outputs
