"""Pipelined pattern verification — concurrent compile, serial timing.

In the source papers the dominant cost of automatic offloading is pattern
verification: every candidate pattern costs ~3 h of OpenCL/HDL compilation,
and Yamato's method bounds wall-clock by compiling multiple candidates *in
parallel* on the verification environment (arXiv 2004.08548; the GA variant
in arXiv 2011.12431 verifies a whole population per generation).  This
module is that parallelism for the port:

* :class:`VerificationExecutor` — takes a *batch* of verify jobs (one per
  ledger-missing proposal), runs their compile steps
  (:func:`~repro_torch.core.search.compile_pattern`: the ``nvcc`` builds of
  the CUDA sources the pattern's ``hopper`` genes need, then
  ``program.build(impl)`` — host-only work) concurrently on a
  ``ThreadPoolExecutor`` (``nvcc`` runs in processes of its own), then
  runs the first calls, the captures into CUDA graphs (on a card) and the
  timed reps **strictly serially** in batch order, on this thread
  (``search.time_callable``): a capture never overlaps another pattern's
  reps, and each graph and its memory pool are released when its
  measurement ends, so a plan holds at most one pattern's graph at a time.
  Wall-clock per batch drops from ``Σ(compile + measure)`` toward
  ``max(compile) + Σ(measure)`` while ``run_seconds`` stays clean — no
  pattern's reps ever share the device with another pattern's device work.
* :class:`CompileCache` — in-memory memo of compile futures keyed by
  ``(program, impl_key, arg shapes, registry version)``.  Within one plan
  run it dedupes the speculative compile-ahead against the batch compiles;
  across the plan runs of one :class:`~repro_torch.core.planner
  .AutoOffloader` a pattern already built for the same program and shapes
  is never built again.  It keeps the host artifact (the built callable),
  never a graph: a re-measured pattern is captured anew.
* ``prefetch`` — speculative compile-ahead: a strategy may hint the
  patterns it is likely to propose next (the surrogate GA's predicted
  top-2k), and their compile steps run in the background while earlier
  proposals are being timed.  Compile steps are host work, so they share
  the host, never the device, with a timed rep; serial mode
  (``workers == 1``) never speculates.
* ``map_concurrent`` — the same worker pool fanned out over the Step-3
  ``resources.precompile`` calls (order-preserving).

With ``workers == 1`` compiles run inline in proposal order and nothing is
speculative.  Determinism is independent of ``workers`` by construction —
worker count changes *when* a compile happens, never what is measured or
selected.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core import search  # module ref: monkeypatched fns stay honored


@dataclass(frozen=True)
class FaultPolicy:
    """Fault-tolerance policy for pattern verification.

    * ``compile_timeout_s`` — wall ceiling per compile step (0 = off).
      Expiry is a transient ``CompileTimeout``; the hung compile's worker
      is abandoned, its cache entry invalidated, and the bounded retry
      recompiles fresh.
    * ``run_timeout_s`` — wall ceiling per execution, first call and every
      timed rep (0 = off); expiry is a transient ``RunTimeout`` and the
      device is drained before anything else is timed.
    * ``max_retries`` / ``retry_backoff_s`` — bounded retry for failures
      :func:`~repro_torch.core.search.classify_failure` calls transient,
      with exponential backoff (``backoff * 2**attempt``, capped at 2 s).
      Permanent failures never retry — they strike the quarantine instead.
    * ``check_finite`` — a NaN/Inf-producing pattern fails permanently
      (``NonFiniteOutput``) instead of winning on garbage speed.
    * ``outlier_mad`` / ``remeasure`` — modified-z-score rejection over the
      timed reps with bounded re-measurement (see ``time_callable``).
    """
    compile_timeout_s: float = 0.0
    run_timeout_s: float = 0.0
    max_retries: int = 2
    retry_backoff_s: float = 0.05
    check_finite: bool = True
    outlier_mad: float = 3.5
    remeasure: int = 2


def measure_with_retry(measure_once: Callable[[], tuple],
                       policy: FaultPolicy) -> search.Measurement:
    """Bounded-retry driver around a measurement thunk.

    ``measure_once()`` performs ONE attempt and returns ``(measurement,
    fresh_compile)`` — the flag says whether that attempt paid for its own
    compile.  Transient failures retry with exponential backoff up to
    ``policy.max_retries``; the returned measurement's ``attempts`` counts
    every try, and the compile seconds burned by failed fresh attempts are
    folded into ``compile_seconds`` / ``compile_wall_s`` — retries are
    billed, never hidden."""
    attempts = 0
    extra_compile = 0.0
    drained = False
    while True:
        attempts += 1
        m, fresh_compile = measure_once()
        m.attempts = attempts
        drained = drained or m.drained
        if (m.ok or attempts > policy.max_retries
                or m.failure_kind != "transient"):
            m.compile_seconds += extra_compile
            m.compile_wall_s += extra_compile
            m.drained = drained
            return m
        if fresh_compile or m.failure_phase == "compile":
            extra_compile += m.compile_seconds
        if policy.retry_backoff_s > 0:
            time.sleep(min(policy.retry_backoff_s * (2 ** (attempts - 1)),
                           2.0))


def compile_key(program: str, impl, args) -> tuple:
    """CompileCache identity of one verify job: the program, the canonical
    offload pattern, the shapes/dtypes of the sample it is built for, and
    the variant-registry version.  Tile-parameter genes flow through
    ``search.impl_key`` canonicalization, so distinct tile points are
    distinct jobs while a defaulted-param gene shares the bare variant's.
    The registry version makes re-registering any variant invalidate
    cross-run reuse, so a re-plan after a kernel edit never times a stale
    build."""
    from repro_torch.core.regions import registry_version
    sig = tuple(
        f"{getattr(a, 'dtype', None)}[{','.join(str(d) for d in getattr(a, 'shape', ()))}]"
        for a in args)
    return (program, search.impl_key(impl), sig, registry_version())


@dataclass
class VerifyJob:
    """One pattern to verify: its compile step (``build`` — a thunk that
    returns the built pattern — and the CUDA ``sources`` it needs), its
    concrete sample args, and the cache identity."""
    key: tuple
    build: Callable[[], Callable]
    args: tuple
    pattern: str = ""
    impl: dict | None = None
    sources: tuple = ()


class CompileCache:
    """Thread-safe memo of compile futures keyed by :func:`compile_key`.

    Entries are futures so a prefetch and a batch compile of the same
    pattern collapse onto one compile.  ``prune()`` (called at executor
    shutdown) drops cancelled, failed, and unfinished entries — a failed
    compile is retried on the next plan run, as the plan cache never
    remembers failures."""

    def __init__(self):
        self._lock = threading.Lock()
        self._futures: dict[tuple, Future] = {}
        self.hits = 0
        self.misses = 0

    def get_or_submit(self, key: tuple,
                      submit: Callable[[], Future]) -> tuple[Future, bool]:
        """``(future, fresh)`` for ``key``: an existing future (hit,
        ``fresh=False``) or the one ``submit()`` creates (miss).  A
        placeholder is registered under the lock and ``submit()`` runs
        OUTSIDE it, so callers on other keys never wait behind it."""
        with self._lock:
            fut = self._futures.get(key)
            if fut is not None:
                self.hits += 1
                return fut, False
            self.misses += 1
            placeholder: Future = Future()
            self._futures[key] = placeholder
        try:
            inner = submit()
        except BaseException as e:
            with self._lock:
                self._futures.pop(key, None)
            placeholder.set_exception(e)
            raise

        def _copy(f: Future) -> None:
            if f.cancelled():
                placeholder.cancel()
            elif f.exception() is not None:
                placeholder.set_exception(f.exception())
            else:
                placeholder.set_result(f.result())

        inner.add_done_callback(_copy)
        return placeholder, True

    def __len__(self) -> int:
        with self._lock:
            return len(self._futures)

    def __contains__(self, key: tuple) -> bool:
        with self._lock:
            return key in self._futures

    def invalidate(self, key: tuple) -> None:
        """Drop one entry (a timed-out or failed compile the retry loop
        wants to redo fresh).  The abandoned future keeps running on its
        worker — the cache just stops serving it."""
        with self._lock:
            self._futures.pop(key, None)

    def prune(self) -> None:
        """Drop entries that cannot be served again: cancelled or still
        pending futures and failed compiles."""
        with self._lock:
            keep = {}
            for key, fut in self._futures.items():
                if not fut.done() or fut.cancelled():
                    continue
                if fut.exception() is not None:
                    continue
                if getattr(fut.result(), "ok", False):
                    keep[key] = fut
            self._futures = keep


@dataclass
class ExecutorStats:
    """Wall-clock accounting of one executor's lifetime (one plan run)."""
    workers: int = 1
    batches: int = 0
    compiled: int = 0            # compile steps actually run (cache misses)
    prefetched: int = 0          # speculative compiles submitted
    compile_wall_s: float = 0.0  # wall the serial pipeline BLOCKED on compiles
    compile_seconds_total: float = 0.0   # true compile durations, summed
    verify_wall_s: float = 0.0   # wall of the batched verification phases
    cache_hits: int = 0
    cache_misses: int = 0
    drained: int = 0             # measurements that drained the device

    def as_dict(self) -> dict:
        return {
            "workers": self.workers,
            "batches": self.batches,
            "compiled": self.compiled,
            "prefetched": self.prefetched,
            "compile_wall_s": self.compile_wall_s,
            "compile_seconds_total": self.compile_seconds_total,
            "verify_wall_s": self.verify_wall_s,
            "compile_cache_hits": self.cache_hits,
            "compile_cache_misses": self.cache_misses,
            "drained": self.drained,
        }


class VerificationExecutor:
    """Concurrent-compile / serial-time executor for Steps 3 and 4.

    * ``workers`` — thread-pool width for compile steps and the Step-3
      fan-out; ``1`` (the default) compiles inline, serially.
    * ``cache`` — a :class:`CompileCache` to dedupe compiles against; the
      planner passes its ``AutoOffloader``-lifetime cache.
    * ``policy`` — the :class:`FaultPolicy` for every job measured here.
    """

    def __init__(self, workers: int = 1,
                 cache: Optional[CompileCache] = None,
                 policy: Optional[FaultPolicy] = None):
        self.workers = max(1, int(workers))
        self.cache = cache if cache is not None else CompileCache()
        self.policy = policy if policy is not None else FaultPolicy()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._abandoned = False    # a compile timed out: its worker may hang
        self._lock = threading.Lock()
        self._fresh_keys: set = set()   # compiled by THIS executor's run
        # the shared cache outlives this executor: per-run stats report the
        # DELTA from these construction baselines
        self._cache_hits0 = self.cache.hits
        self._cache_misses0 = self.cache.misses
        self.stats = ExecutorStats(workers=self.workers)

    @property
    def pipelined(self) -> bool:
        """Whether compiles may overlap (workers > 1)."""
        return self.workers > 1

    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.workers,
                                            thread_name_prefix="verify")
        return self._pool

    def _compile_async(self, job: VerifyJob) -> tuple[Future, bool]:
        """The (deduped) ``(future, fresh)`` compiling ``job`` on the pool."""
        def submit() -> Future:
            with self._lock:
                self.stats.compiled += 1
            return self._ensure_pool().submit(search.compile_pattern,
                                              job.build, job.sources)
        fut, fresh = self.cache.get_or_submit(job.key, submit)
        with self._lock:
            if fresh:
                self._fresh_keys.add(job.key)
            self.stats.cache_hits = self.cache.hits - self._cache_hits0
            self.stats.cache_misses = self.cache.misses - self._cache_misses0
        return fut, fresh

    def prefetch(self, jobs: list[VerifyJob]) -> None:
        """Speculative compile-ahead of ``jobs`` in the background.  No-op
        in serial mode (``workers == 1``)."""
        if not self.pipelined:
            return
        for job in jobs:
            _, fresh = self._compile_async(job)
            if fresh:
                with self._lock:
                    self.stats.prefetched += 1

    def _measure_job(self, job: VerifyJob, *, warmup: int, reps: int,
                     precompiled: Optional[search.CompiledArtifact] = None,
                     ) -> search.Measurement:
        """One job through the fault policy; a compile-phase transient
        failure drops the job's CompileCache entry so the retry compiles
        fresh inline."""
        p = self.policy
        state = {"art": precompiled}

        def once():
            art = state["art"]
            fresh = art is None
            if fresh:
                art = search.compile_pattern(job.build, job.sources,
                                             p.compile_timeout_s)
            m = search.time_callable(
                None, job.args, warmup=warmup, reps=reps,
                pattern=job.pattern, impl=job.impl, precompiled=art,
                run_timeout_s=p.run_timeout_s,
                check_finite=p.check_finite,
                outlier_mad=p.outlier_mad, remeasure=p.remeasure)
            if (not m.ok and m.failure_kind == "transient"
                    and m.failure_phase == "compile"):
                self.cache.invalidate(job.key)
                state["art"] = None
            return m, fresh

        return measure_with_retry(once, p)

    def measure_batch(self, jobs: list[VerifyJob], *, warmup: int = 1,
                      reps: int = 5) -> list[search.Measurement]:
        """Verify a batch: every job's compile step in flight at once
        (pipelined mode), then every first call and timed rep strictly
        serially in batch order.  Serial mode compiles inline per job."""
        t_batch = time.perf_counter()
        out: list[search.Measurement] = []
        if not self.pipelined:
            for job in jobs:
                m = self._measure_job(job, warmup=warmup, reps=reps)
                with self._lock:
                    self.stats.compile_wall_s += m.compile_seconds
                    self.stats.compile_seconds_total += m.compile_seconds
                    self.stats.drained += int(m.drained)
                out.append(m)
        else:
            # phase 1 — compile BARRIER: every job's compile step in flight
            # at once, all finished before any device work.  With a compile
            # timeout no single wait may exceed it: an expired future
            # becomes a transient CompileTimeout (phase 2 retries it fresh)
            # and the hung worker is flagged so shutdown doesn't join it.
            ceiling = (self.policy.compile_timeout_s
                       if self.policy.compile_timeout_s > 0 else None)
            futures = [self._compile_async(job)[0] for job in jobs]
            arts, waits = [], []
            for job, fut in zip(jobs, futures):
                t0 = time.perf_counter()
                try:
                    arts.append(fut.result(ceiling))
                except FutureTimeout:
                    with self._lock:
                        self._abandoned = True
                    self.cache.invalidate(job.key)
                    arts.append(search.CompiledArtifact(
                        None, time.perf_counter() - t0,
                        f"CompileTimeout: exceeded {ceiling:.3f}s wall"))
                except Exception as e:  # noqa: BLE001 — classified downstream
                    arts.append(search.CompiledArtifact(
                        None, time.perf_counter() - t0,
                        f"{type(e).__name__}: {e}"))
                waits.append(time.perf_counter() - t0)
            # phase 2 — strictly serial device work
            for job, art, wait_s in zip(jobs, arts, waits):
                m = self._measure_job(job, warmup=warmup, reps=reps,
                                      precompiled=art)
                # what the timing thread compiled itself: the capture (on
                # a card) and what failed tries burned, billed here as in
                # serial mode
                inline_s = m.compile_seconds - art.compile_seconds
                m.compile_wall_s = wait_s + inline_s
                with self._lock:
                    self.stats.compile_wall_s += m.compile_wall_s
                    self.stats.drained += int(m.drained)
                    self.stats.compile_seconds_total += inline_s
                    # a warm CompileCache hit from a previous plan did no
                    # compile now: count its duration only when THIS run
                    # compiled it
                    if job.key in self._fresh_keys:
                        self._fresh_keys.discard(job.key)
                        self.stats.compile_seconds_total += art.compile_seconds
                out.append(m)
        with self._lock:
            self.stats.batches += 1
            self.stats.verify_wall_s += time.perf_counter() - t_batch
        return out

    def measure_one(self, job: VerifyJob, *, warmup: int = 1,
                    reps: int = 5) -> search.Measurement:
        """Single-proposal verification — a batch of one, so a prefetched
        compile is found warm in the cache."""
        return self.measure_batch([job], warmup=warmup, reps=reps)[0]

    def map_concurrent(self, fn: Callable, items: list) -> list:
        """Order-preserving concurrent map on the worker pool (the Step-3
        fan-out).  Serial mode is a plain map."""
        items = list(items)
        if not self.pipelined or len(items) <= 1:
            return [fn(x) for x in items]
        return list(self._ensure_pool().map(fn, items))

    def shutdown(self) -> None:
        """Stop the pool (cancelling queued speculative compiles) and prune
        the cache.  An executor that saw a compile timeout does NOT wait for
        its workers — one of them may be wedged."""
        if self._pool is not None:
            self._pool.shutdown(wait=not self._abandoned,
                                cancel_futures=True)
            self._pool = None
        self.cache.prune()
        with self._lock:
            self.stats.cache_hits = self.cache.hits - self._cache_hits0
            self.stats.cache_misses = self.cache.misses - self._cache_misses0
