"""Verification-environment measurement (paper Step 4 executor).

The paper compiles each candidate pattern for the FPGA (~3 h) and runs the
app's sample benchmark; the JAX package compiles it into one XLA
executable (``jax.jit(fn).lower(*args).compile()``) and times that.  Here a
pattern is captured into one CUDA graph on a card and its replays are
timed; the *structure* (bounded number of measured patterns,
best-of-measured selection) is identical.

A pattern's cost is split in two, as the JAX package splits its AOT path:

* **compile** is host work, then one capture.  :func:`compile_pattern`
  runs the ``nvcc`` builds of the CUDA sources the pattern's ``hopper``
  genes launch (``kernels/_build.py``, one per source, skipped when the
  library is current) and ``program.build(impl)``.  Nothing there touches
  the device, so a verification executor (``core/executor.py``) runs many
  compiles concurrently on a thread pool.  The capture (and the graph's
  first, uploading replay) runs later, on the serial timing thread
  (:func:`time_callable`), after the first call.  ``compile_seconds`` is
  host compile + capture, as the JAX package's is lower + compile.
* **run** is device work, strictly serial.  The first synchronized call is
  eager (``first_run_seconds``: allocator warm-up, the kernels' module
  loads, the first launches; its output is the one the finite check
  reads).  On a card the pattern is then captured into a
  ``torch.cuda.CUDAGraph`` on a stream of its own, in ``thread_local``
  capture mode and into a private memory pool of the graph's own
  (``core/cuda_graphs.py``), and replayed once, which uploads it (billed
  to the compile step with the capture); ``warmup - 1`` replays and
  ``reps`` timed replays follow, each rep bracketed by
  ``torch.cuda.Event(enable_timing=True)`` records on that stream, the
  start event queued behind a device-side wait (``TIMING_GATE_CYCLES``) so
  that the host's launch of the replay falls outside the interval, and the
  graph and its pool are released when the measurement ends.  A capture
  that fails is a failed measurement (phase ``"compile"``, permanent, the
  capture's error text): a pattern is never timed eagerly on a card.  On
  the CPU there is no graph: the calls run eagerly, timed with
  ``time.perf_counter`` (monotonic — ``time.time`` can jump under clock
  adjustments).  ``Measurement.timed_as`` says which (``"graph"`` or
  ``"eager"``).

A built pattern may carry a host seam (``fn.inner`` and ``fn.seam``, as
``core/faults.wrap_program`` builds it): the graph captures ``inner``, and
every replay's outputs go through ``seam`` on the host, outside the graph,
so a run-site fault fires per replay as it fires per eager call.

A rep waits on its own stream only, never on the whole device: on an idle
card that is the same, and while the device serves other work (the online
replanner's search runs while the engine ticks) the other thread's work is
neither waited for nor timed.  It still shares the card's SMs and memory
bandwidth with that work; what is left is that contention, not the other
work's duration.

``MeasurementLedger`` is the in-run analogue of the persistent plan cache:
search strategies propose offload patterns through it, a pattern re-proposed
within one plan run is served from the ledger, and only ledger *misses*
consume the measurement budget ``d``.  The ledger is thread-safe and speaks
both single (``measure``) and batched (``measure_batch``) ask–tell, plus a
free ``prefetch`` hint channel for speculative compile-ahead.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.core.cuda_graphs import GraphCall
from repro_torch.core.regions import (Impl, canonical_gene, gene_variant,
                                      split_gene)

# the CUDA source each region's ``hopper`` variant launches
# (``kernels/csrc/<source>.cu``); a stitched region ``a+b`` needs the
# sources of its parts
# A timed rep on a card queues a device-side wait of this many cycles
# (~1 ms at an H100's 1.98 GHz) before its start event, so that the host
# has queued the rep's replay when the start event runs and the interval
# holds the device's work alone.  Without it the interval also held the
# host's launch of the graph, which varies by tens of microseconds from rep
# to rep and decided near-ties between patterns whose device work takes
# ~10 us (tools/decode_tune_repeat.py).
TIMING_GATE_CYCLES = 2_000_000

HOPPER_SOURCES = {
    "fir_bank": "fir",
    "compute_q": "mriq",
    "attn_core": "flash_attention",
    "decode_attn": "decode_attention",
    "ssm_scan": "ssm_scan",
    "rglru_scan": "rglru_scan",
    "rmsnorm": "rmsnorm",
}


@dataclass
class Measurement:
    pattern: str
    # the compile step: nvcc builds + build(impl) on the host, then (on a
    # card) the capture into a CUDA graph and its uploading replay
    compile_seconds: float
    run_seconds: float          # median of the kept reps
    runs: list[float]
    ok: bool = True
    error: str = ""
    # structured offload pattern {region -> variant}; `pattern` is only its
    # human-readable rendering
    impl: dict | None = None
    first_run_seconds: float = 0.0   # the first, synchronized call
    # wall the (serial) verification pipeline was blocked on this pattern's
    # compile: compile_seconds when it ran inline, less when a concurrent
    # executor had it built before the timing phase reached it
    compile_wall_s: float = 0.0
    # fault-tolerance provenance: tries spent on the pattern (1 = first try
    # succeeded; the compile seconds of failed tries are folded into
    # compile_seconds), and on failure the classify_failure() verdict and
    # the phase that died ("compile", "first call" or "run")
    attempts: int = 1
    failure_kind: str = ""
    failure_phase: str = ""
    outliers_rejected: int = 0   # timed reps dropped by MAD rejection
    # a run timed out: its abandoned thread's launches were drained from
    # the device before anything else was timed
    drained: bool = False
    # how the reps were timed: "graph" (replays of one CUDA graph, on a
    # card) or "eager" (calls, on the CPU)
    timed_as: str = "eager"

    def mapping(self) -> dict:
        """The measured {region -> variant} mapping (empty = all-ref)."""
        return dict(self.impl) if self.impl else {}


@dataclass
class CompiledArtifact:
    """One compile outcome: the built callable (or the failure) and the
    compile step's wall time.  Produced by :func:`compile_pattern` —
    possibly on a worker thread — and consumed by
    ``time_callable(precompiled=...)`` on the serial timing thread."""
    fn: Callable | None              # the built pattern; None if it failed
    compile_seconds: float
    error: str = ""

    @property
    def ok(self) -> bool:
        return self.fn is not None


def pattern_sources(impl) -> tuple[str, ...]:
    """The CUDA sources a pattern's ``hopper`` genes launch, sorted."""
    out = set()
    for region, gene in dict(impl).items():
        if split_gene(gene)[0] != "hopper":
            continue
        for part in region.split("+"):
            if part in HOPPER_SOURCES:
                out.add(HOPPER_SOURCES[part])
    return tuple(sorted(out))


def compile_pattern(build: Callable[[], Callable], sources=(),
                    timeout_s: float = 0.0) -> CompiledArtifact:
    """The host-only compile step: load (building when stale) every CUDA
    source in ``sources``, then ``build()`` the pattern.  Safe to run many
    at once on a thread pool (``nvcc`` runs in processes of its own; the
    build module locks per source).  ``timeout_s > 0`` runs it under
    :func:`watchdog_call`; expiry is a transient ``CompileTimeout``.  Never
    raises: a failure returns a non-``ok`` artifact that still accounts the
    seconds spent failing."""
    if timeout_s and timeout_s > 0:
        ok, art, err = watchdog_call(compile_pattern, (build, sources),
                                     timeout_s=timeout_s)
        return art if ok else CompiledArtifact(None, timeout_s,
                                               f"CompileTimeout: {err}")
    t0 = time.perf_counter()
    try:
        if sources:
            from repro_torch.kernels import _build
            for name in sources:
                _build.load(name)
        fn = build()
        return CompiledArtifact(fn, time.perf_counter() - t0)
    except Exception as e:  # noqa: BLE001 — a pattern failing = not a solution
        return CompiledArtifact(None, time.perf_counter() - t0,
                                f"{type(e).__name__}: {e}")


# ---------------------------------------------------------------------------
# Fault tolerance: watchdog, failure classification, outlier rejection
# ---------------------------------------------------------------------------
# Error-message markers that make a failure *transient* — worth a bounded
# retry with backoff.  Everything else (shape/type errors, kernel build
# failures, non-finite outputs, injected permanent faults) is permanent: a
# retry cannot fix it and repeat offenders are quarantined instead.  The
# JAX package's markers, plus the CUDA allocator's own message.
TRANSIENT_MARKERS = (
    "WatchdogTimeout",
    "CompileTimeout",
    "RunTimeout",
    "/transient",                  # InjectedFault[kind/transient]
    "RESOURCE_EXHAUSTED",
    "DEADLINE_EXCEEDED",
    "UNAVAILABLE",
    "OutOfMemory",                 # torch.OutOfMemoryError
    "out of memory",               # the allocator's and the driver's message
)


def classify_failure(error: str) -> str:
    """``"transient"`` or ``"permanent"`` for a measurement error string.

    Transient = the environment failed (timeout, device memory exhausted,
    a flaky device): retrying the identical measurement may succeed.
    Permanent = the *pattern* failed (it does not run on these arguments,
    its kernel does not build, it produces NaN/Inf): retrying is wasted
    budget, so permanent failures strike the pattern's genes in the
    :class:`Quarantine` instead."""
    err = str(error or "")
    if not err:
        return "permanent"
    if "/permanent" in err or "NonFiniteOutput" in err:
        return "permanent"
    return ("transient" if any(m in err for m in TRANSIENT_MARKERS)
            else "permanent")


def watchdog_call(fn, args=(), *, timeout_s: float):
    """Run ``fn(*args)`` under a wall-clock watchdog.

    Returns ``(ok, value, error)``.  The work runs on a daemon thread
    joined with ``timeout_s``; on expiry the thread is *abandoned* (Python
    cannot kill a thread, and nothing can stop a CUDA kernel that is
    already running — the caller drains the device before it times
    anything else) and the error is ``WatchdogTimeout`` — classified
    transient, so the retry loop gets its bounded second chance."""
    box: dict = {}

    def target():
        try:
            box["value"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 — reported to the caller
            box["error"] = f"{type(e).__name__}: {e}"

    t = threading.Thread(target=target, daemon=True, name="measure-watchdog")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        return False, None, f"WatchdogTimeout: exceeded {timeout_s:.3f}s wall"
    if "error" in box:
        return False, None, box["error"]
    return True, box.get("value"), ""


def _mad_reject(runs: list, z: float) -> tuple[list, int]:
    """Split timed reps into (kept, n_rejected) by modified z-score:
    ``|x - median| / (1.4826 * MAD) > z`` rejects.  A zero MAD (at least
    half the reps identical) rejects nothing — the median is already
    robust there."""
    med = float(np.median(runs))
    mad = float(np.median([abs(x - med) for x in runs]))
    if mad <= 0.0:
        return list(runs), 0
    kept = [x for x in runs if abs(x - med) / (1.4826 * mad) <= z]
    return kept, len(runs) - len(kept)


def _nonfinite(tree) -> bool:
    """True when any floating or complex tensor of an output tree holds
    NaN/Inf."""
    return any((t.is_floating_point() or t.is_complex())
               and not bool(torch.isfinite(t).all())
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _device_of(args) -> torch.device:
    for t in tree_leaves(args):
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def graph_type(device: torch.device):
    """The graph class a pattern is captured into on ``device``:
    ``torch.cuda.CUDAGraph`` on a card, None (eager calls) elsewhere.  The
    one seam through which a test stands a fake graph in for it."""
    return torch.cuda.CUDAGraph if device.type == "cuda" else None


def capture_pattern(fn, args, *, stream=None) -> GraphCall | None:
    """The device work of the built pattern ``fn`` on ``args`` (its
    ``inner``, where it carries a host seam) captured into a graph of
    :func:`graph_type`, on ``stream`` (on a card by default a new side
    stream ordered after the current one), and replayed once; None where
    there is no graph type (the CPU).  Raises when the capture or that
    replay fails.  The caller has called ``fn`` once eagerly (module
    loads, kernel builds, allocator warm-up) and releases the graph
    (:meth:`GraphCall.release`).

    The first launch of a graph uploads it to the device, which costs
    about a microsecond a node (tdFIR's all-ref graph of ~1,200 nodes:
    3.38 ms at its first replay, 2.31 ms at its second, on an NVIDIA H100
    80GB HBM3 at 700.00 W, ``tools/staged_repeat.py``), so that replay
    belongs to the compile step, as loading an executable belongs to the
    JAX package's, and no timed replay pays it."""
    dev = _device_of(args)
    new_graph = graph_type(dev)
    if new_graph is None:
        return None
    cuda = dev.type == "cuda"
    if stream is None and cuda:
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
    graph = GraphCall(new_graph(), getattr(fn, "inner", fn), args,
                      stream=stream)
    try:
        with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
            graph.replay()
        if cuda:
            stream.synchronize()
    except BaseException:
        graph.release()
        raise
    return graph


def replay_bit_equal(graph: GraphCall, want, args) -> bool:
    """Whether a replay of ``graph`` (captured on ``args``) gives ``want``,
    the output of an eager call on ``args`` (taken before the capture),
    bit for bit.  Its floating outputs that are not inputs are filled with
    NaN first, so a replay that writes nothing cannot pass."""
    def tensors(tree):
        return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]

    inputs = {t.data_ptr() for t in tensors(args)}
    for t in tensors(graph.outputs):
        if t.data_ptr() not in inputs and (t.is_floating_point()
                                           or t.is_complex()):
            t.fill_(float("nan"))
    got, want = tensors(graph.replay()), tensors(want)
    if any(t.is_cuda for t in got):
        torch.cuda.synchronize()
    return len(got) == len(want) and all(
        torch.equal(g, w) for g, w in zip(got, want))


class _RunFailure(RuntimeError):
    """Internal: a run-phase failure whose message is already formatted
    (the watchdog path) — the outer handler must not re-prefix it."""


def time_callable(fn, args, *, warmup: int = 1, reps: int = 5,
                  pattern: str = "", impl: dict | None = None,
                  precompiled: CompiledArtifact | None = None,
                  run_timeout_s: float = 0.0,
                  check_finite: bool = False,
                  outlier_mad: float = 0.0,
                  remeasure: int = 0) -> Measurement:
    """Measure one offload pattern: ``fn`` (or the pattern a
    :func:`compile_pattern` artifact ``precompiled`` holds, whose compile
    seconds — or failure — the Measurement then reports), the first
    synchronized call, then (on a card) its capture into a CUDA graph,
    ``warmup - 1`` more calls and ``reps`` timed calls — replays of the
    graph on a card, eager calls on the CPU; ``run_seconds`` is the median
    of the kept reps.  Timing runs on the device of ``args``' tensors (CUDA
    events on a card).  The capture's seconds are billed to
    ``compile_seconds``; a capture that fails is a permanent failure of
    phase ``"compile"``.  The graph is released before this returns.

    Fault-tolerance knobs (all off by default):

    * ``run_timeout_s > 0`` runs every call (first, warm-up, each timed
      rep) under the watchdog; expiry is a transient ``RunTimeout``, after
      which the whole device is synchronized — the abandoned call's
      launches must not fall inside the next pattern's reps — and the
      Measurement says ``drained``.  A
      launch that fails during the drain (a kernel that trapped) raises
      out of here: a dead device is not a slow pattern.
    * ``check_finite`` fails the measurement (permanent ``NonFiniteOutput``)
      when the first call produces NaN/Inf.
    * ``outlier_mad > 0`` rejects timed reps whose modified z-score exceeds
      the threshold, re-measures up to ``remeasure`` replacement reps, and
      reports the median of the kept reps; ``runs`` keeps every raw rep and
      ``outliers_rejected`` the count.

    Never raises for a failing pattern: a failure is a Measurement with
    ``ok=False``."""
    impl = dict(impl) if impl is not None else None
    art = precompiled if precompiled is not None else CompiledArtifact(fn, 0.0)
    compile_s = art.compile_seconds

    def failed(phase: str, error: str, drained: bool = False,
               kind: str = "") -> Measurement:
        return Measurement(pattern, compile_s, float("inf"), [],
                           False, error, impl=impl,
                           compile_wall_s=compile_s,
                           failure_kind=kind or classify_failure(error),
                           failure_phase=phase, drained=drained)

    if not art.ok:
        return failed("compile", art.error)
    call = art.fn
    seam = getattr(call, "seam", None)
    dev = _device_of(args)
    cuda = dev.type == "cuda"
    stream = None
    if cuda:
        stream = torch.cuda.Stream(dev)
        # the sample inputs were made on the caller's stream
        stream.wait_stream(torch.cuda.current_stream(dev))
    graph: GraphCall | None = None

    def drain() -> None:
        if cuda:
            stream.synchronize()

    def on_stream():
        return (torch.cuda.stream(stream) if cuda
                else contextlib.nullcontext())

    def again():
        # every call after the first: a replay, its outputs through the
        # pattern's host seam, or (no graph) an eager call
        if graph is None:
            return call(*args)
        out = graph.replay()
        return out if seam is None else seam(out)

    def first_call():
        with on_stream():
            drain()
            out = call(*args)
            drain()
        return out

    def plain_call():
        with on_stream():
            return again()

    def timed_rep() -> float:
        with on_stream():
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                drain()
                torch.cuda._sleep(TIMING_GATE_CYCLES)
                start.record(stream)
                again()
                end.record(stream)
                end.synchronize()
                return start.elapsed_time(end) / 1e3
            t = time.perf_counter()
            again()
            return time.perf_counter() - t

    def guarded(body):
        if not (run_timeout_s and run_timeout_s > 0):
            return body()
        ok, value, err = watchdog_call(body, timeout_s=run_timeout_s)
        if not ok:
            if "WatchdogTimeout" in err:
                if cuda:
                    torch.cuda.synchronize(dev)
                raise _RunFailure(f"RunTimeout: {err}")
            raise _RunFailure(err)
        return value

    with torch.cuda.device(dev) if cuda else contextlib.nullcontext():
        t0 = time.perf_counter()
        try:
            out = guarded(first_call)
        except _RunFailure as e:
            return failed("first call", str(e), "RunTimeout" in str(e))
        except Exception as e:  # noqa: BLE001 — a pattern failing = not a solution
            return failed("first call", f"{type(e).__name__}: {e}")
        first_s = time.perf_counter() - t0
        if check_finite and _nonfinite(out):
            return failed("run", "NonFiniteOutput: pattern produced NaN/Inf")
        del out
        # the compile step's device half: the capture, on this (the serial
        # timing) thread, never under the run watchdog — an abandoned
        # capture would hold the one-capture lock
        t0 = time.perf_counter()
        try:
            graph = capture_pattern(call, args, stream=stream)
        except Exception as e:  # noqa: BLE001 — a pattern failing = not a solution
            compile_s += time.perf_counter() - t0
            return failed("compile", f"GraphCapture: {type(e).__name__}: {e}",
                          kind="permanent")
        compile_s += time.perf_counter() - t0
        timed_as = "eager" if graph is None else "graph"
        try:
            for _ in range(max(warmup - 1, 0)):
                guarded(plain_call)
            runs = [guarded(timed_rep) for _ in range(reps)]
            rejected = 0
            kept = runs
            if outlier_mad and outlier_mad > 0 and len(runs) >= 3:
                kept, rejected = _mad_reject(runs, outlier_mad)
                # bounded re-measurement: replace (some of) the rejected
                # reps, then re-filter the full raw set once
                for _ in range(min(rejected, max(int(remeasure), 0))):
                    runs.append(guarded(timed_rep))
                if rejected:
                    refiltered, rejected = _mad_reject(runs, outlier_mad)
                    kept = refiltered if refiltered else kept
        except _RunFailure as e:
            return failed("run", str(e), "RunTimeout" in str(e))
        except Exception as e:  # noqa: BLE001 — a pattern failing = not a solution
            return failed("run", f"{type(e).__name__}: {e}")
        finally:
            if graph is not None:
                graph.release()
    return Measurement(pattern, compile_s, float(np.median(kept)),
                       runs, impl=impl, first_run_seconds=first_s,
                       compile_wall_s=compile_s,
                       outliers_rejected=rejected, timed_as=timed_as)


# ---------------------------------------------------------------------------
# Measurement ledger — budget-aware dedup for the search strategies
# ---------------------------------------------------------------------------
def impl_key(impl) -> tuple:
    """Canonical hashable identity of an offload pattern: the sorted non-ref
    genes.  ``{a: ref, b: offload}`` and ``{b: offload}`` are the same
    program and must hit the same ledger entry; params equal to a variant's
    declared defaults canonicalize away (see
    :func:`repro_torch.core.regions.canonical_gene`)."""
    return tuple(sorted((r, canonical_gene(r, v))
                        for r, v in dict(impl).items()
                        if gene_variant(v) != "ref"))


class Quarantine:
    """Strike list for (region, variant[, tile]) genes that fail repeatedly.

    Gene identity is the canonical single-gene rendering
    (``Impl({region: gene}).describe()``), so a defaulted-tile gene and the
    bare variant share one record while distinct tile points are tracked
    separately — the same canonicalization the ledger key uses.

    ``record`` strikes every non-ref gene of a failed measurement (a failed
    multi-gene pattern can't name its culprit, so all its genes are
    suspects).  A gene reaching ``threshold`` strikes is quarantined: the
    planner filters it from the Step-3 ranking, strategies stop proposing
    it (:meth:`SearchState.gene_allowed`), and the replanner never
    re-offers a plan containing it.  Records round-trip through
    :class:`~repro_torch.core.plan_cache.PlanCache` entries under
    ``measurement_key`` so future runs skip known-bad genes without
    re-paying their failures.  Transient failures are retried to success
    by the executor and never reach ``record`` — only permanent,
    retry-exhausted failures strike.
    """

    def __init__(self, threshold: int = 2):
        self.threshold = max(1, int(threshold))
        self._lock = threading.Lock()
        self._strikes: dict[str, int] = {}
        self._errors: dict[str, str] = {}

    @staticmethod
    def gene_id(region: str, gene) -> str:
        """Canonical persistent identity of one (region, gene)."""
        return Impl({region: gene}).describe()

    def record(self, m: Measurement) -> list[str]:
        """Strike the genes of a failed measurement; returns the gene ids
        that just crossed the quarantine threshold."""
        if m.ok:
            return []
        return self.record_failure(m.mapping(), m.error)

    def record_failure(self, impl, error: str) -> list[str]:
        """Strike every non-ref gene of ``impl`` directly (the serving-side
        feedback path, where no Measurement exists — a plan that faulted
        mid-serve or that the canary vetoed)."""
        newly: list[str] = []
        with self._lock:
            for region, gene in sorted(dict(impl).items()):
                if gene_variant(gene) == "ref":
                    continue
                gid = self.gene_id(region, gene)
                n = self._strikes.get(gid, 0) + 1
                self._strikes[gid] = n
                self._errors[gid] = str(error)
                if n == self.threshold:
                    newly.append(gid)
        return newly

    def is_quarantined(self, region: str, gene) -> bool:
        gid = self.gene_id(region, gene)
        with self._lock:
            return self._strikes.get(gid, 0) >= self.threshold

    def allows(self, impl) -> bool:
        """True when no gene of the pattern is quarantined."""
        return not any(self.is_quarantined(r, g)
                       for r, g in dict(impl).items()
                       if gene_variant(g) != "ref")

    def blocked(self) -> list[str]:
        """Gene ids currently at/over the threshold, sorted."""
        with self._lock:
            return sorted(g for g, n in self._strikes.items()
                          if n >= self.threshold)

    def strikes(self) -> dict[str, int]:
        with self._lock:
            return dict(self._strikes)

    def to_records(self) -> list[dict]:
        """JSON-serializable strike records (persisted in cache entries)."""
        with self._lock:
            return [{"gene": g, "strikes": n,
                     "last_error": self._errors.get(g, "")}
                    for g, n in sorted(self._strikes.items())]

    def load_records(self, records) -> None:
        """Merge persisted records; the max strike count per gene wins
        (each persisted record is already a cumulative snapshot)."""
        for rec in records or ():
            if not isinstance(rec, dict):
                continue
            gene = rec.get("gene")
            try:
                n = int(rec.get("strikes", 0))
            except (TypeError, ValueError):
                continue
            if not isinstance(gene, str) or n <= 0:
                continue
            with self._lock:
                if n > self._strikes.get(gene, 0):
                    self._strikes[gene] = n
                    self._errors[gene] = str(rec.get("last_error", ""))


@dataclass
class MeasurementLedger:
    """In-run measurement memo with the budget attached.

    ``measure(impl)`` returns the cached Measurement on a hit (free), runs
    ``measure_fn`` and decrements ``budget`` on a miss, and returns ``None``
    once the budget is exhausted.  ``order`` is the measured (miss) sequence
    — exactly the patterns that consumed budget, in measurement order.

    ``measure_batch(impls)`` is the batched ask: every hit is served free,
    misses consume budget *in batch order* until it runs out (``None`` for
    the unaffordable tail), and the affordable misses are measured together
    through ``measure_batch_fn`` when one is wired (the verification
    executor: all compiles in flight at once, timed reps strictly serial).
    Without a batch fn, misses are measured one after another through
    ``measure_fn`` — identical results, no pipelining.

    ``prime`` seeds an entry that never bills against ``d``: the all-ref
    baseline (the paper's pre-existing CPU system), and measurements
    recovered from previous runs of the same program on the same backend.

    ``prefetch(impls)`` is a free hint — "these patterns may be proposed
    soon" — forwarded (ledger-missing subset only) to ``prefetch_fn`` so an
    executor can compile ahead.  It never measures and never spends budget.

    ``served`` is every distinct Measurement handed to the strategy this
    run, hits and misses alike, in first-served order — the set the planner
    selects the winner from.

    Thread-safe: concurrent ``measure`` calls on the same pattern collapse
    to one measurement (the losers wait and are served the winner's entry
    as hits), and budget accounting stays exact under races.
    """
    measure_fn: Callable
    budget: int
    measure_batch_fn: Optional[Callable] = None
    prefetch_fn: Optional[Callable] = None
    # failed measurements strike their genes here, so the strategies'
    # quarantine filter sees new offenders mid-run
    quarantine: Optional[Quarantine] = None
    hits: int = 0
    misses: int = 0
    order: list[Measurement] = field(default_factory=list)
    served: list[Measurement] = field(default_factory=list)
    _entries: dict[tuple, Measurement] = field(default_factory=dict)
    _primed: set = field(default_factory=set)
    _served_keys: set = field(default_factory=set)
    _inflight: dict = field(default_factory=dict)   # key -> threading.Event
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def prime(self, impl, measurement: Measurement) -> None:
        """Record a measurement taken outside the budget (the all-ref
        baseline, or a measurement persisted by a previous plan run)."""
        k = impl_key(impl)
        with self._lock:
            self._entries[k] = measurement
            self._primed.add(k)

    def seen(self, impl) -> bool:
        with self._lock:
            return impl_key(impl) in self._entries

    def exhausted(self) -> bool:
        return self.budget <= 0

    def reused(self) -> list[Measurement]:
        """Primed (cross-run / baseline) measurements the strategy actually
        re-proposed this run — served for free."""
        return [m for m in self.served
                if impl_key(m.impl or {}) in self._primed]

    def failures(self) -> list[Measurement]:
        """Budget-consuming measurements that failed, in measurement order
        (each carries ``attempts``, ``failure_kind``, ``failure_phase``)."""
        with self._lock:
            return [m for m in self.order if not m.ok]

    def _serve(self, key: tuple, m: Measurement) -> Measurement:
        # callers hold self._lock
        if key not in self._served_keys:
            self._served_keys.add(key)
            self.served.append(m)
        return m

    def measure(self, impl) -> Optional[Measurement]:
        k = impl_key(impl)
        while True:
            with self._lock:
                hit = self._entries.get(k)
                if hit is not None:
                    self.hits += 1
                    return self._serve(k, hit)
                ev = self._inflight.get(k)
                if ev is None:
                    if self.budget <= 0:
                        return None
                    self.budget -= 1
                    self.misses += 1
                    ev = threading.Event()
                    self._inflight[k] = ev
                    break
            # another thread is measuring this exact pattern: wait for its
            # entry instead of double-spending budget on a duplicate
            ev.wait()
        try:
            m = self.measure_fn(impl)
        except BaseException:
            # measure_fn returns failure Measurements and should not raise;
            # if it does anyway, release any waiters AND refund the reserved
            # budget before propagating — no entry was stored
            with self._lock:
                self.budget += 1
                self.misses -= 1
                self._inflight.pop(k, None)
            ev.set()
            raise
        with self._lock:
            self._entries[k] = m
            self.order.append(m)
            self._inflight.pop(k, None)
            res = self._serve(k, m)
        ev.set()
        if self.quarantine is not None and not m.ok:
            self.quarantine.record(m)
        return res

    def measure_batch(self, impls) -> list[Optional[Measurement]]:
        """Batched ask: one ``Optional[Measurement]`` per input, in order.
        Hits (including in-batch duplicates) are free; misses consume budget
        in batch order and are measured together via ``measure_batch_fn``
        when available."""
        keys = [impl_key(i) for i in impls]
        to_measure: list[tuple] = []          # (key, impl) misses, batch order
        with self._lock:
            reserved = set()
            for k, impl in zip(keys, impls):
                if (k in self._entries or k in reserved
                        or k in self._inflight):
                    continue
                if self.budget <= 0:
                    continue
                self.budget -= 1
                self.misses += 1
                reserved.add(k)
                self._inflight[k] = threading.Event()
                to_measure.append((k, impl))
        measured_keys = {k for k, _ in to_measure}
        if to_measure:
            batch = [impl for _, impl in to_measure]
            try:
                if self.measure_batch_fn is not None:
                    ms = list(self.measure_batch_fn(batch))
                else:
                    ms = [self.measure_fn(impl) for impl in batch]
            except BaseException:
                # refund the whole reservation: nothing was stored
                with self._lock:
                    for k, _ in to_measure:
                        self.budget += 1
                        self.misses -= 1
                        ev = self._inflight.pop(k, None)
                        if ev is not None:
                            ev.set()
                raise
            with self._lock:
                stored: set = set()
                for (k, _), m in zip(to_measure, ms):
                    self._entries[k] = m
                    self.order.append(m)
                    stored.add(k)
                    ev = self._inflight.pop(k, None)
                    if ev is not None:
                        ev.set()
                for k, _ in to_measure:
                    # a short batch_fn return: refund the unmeasured tail
                    if k not in stored:
                        self.budget += 1
                        self.misses -= 1
                        ev = self._inflight.pop(k, None)
                        if ev is not None:
                            ev.set()
            if self.quarantine is not None:
                for m in ms:
                    if m is not None and not m.ok:
                        self.quarantine.record(m)
        # patterns another thread is measuring right now: wait so they can
        # be served below instead of dropped
        for k in set(keys) - measured_keys:
            with self._lock:
                ev = self._inflight.get(k)
            if ev is not None:
                ev.wait()
        out: list[Optional[Measurement]] = []
        with self._lock:
            first_seen: set = set()
            for k in keys:
                m = self._entries.get(k)
                if m is None:                 # unaffordable: budget ran out
                    out.append(None)
                    continue
                if not (k in measured_keys and k not in first_seen):
                    self.hits += 1            # pre-existing or in-batch dup
                first_seen.add(k)
                out.append(self._serve(k, m))
        return out

    def prefetch(self, impls) -> None:
        """Free compile-ahead hint: forwards the subset the ledger has no
        entry (or in-flight measurement) for to ``prefetch_fn``."""
        if self.prefetch_fn is None:
            return
        with self._lock:
            fresh = [i for i in impls
                     if impl_key(i) not in self._entries
                     and impl_key(i) not in self._inflight]
        if fresh:
            self.prefetch_fn(fresh)
