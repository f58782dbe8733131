"""Verification-environment measurement (paper Step 4 executor).

The paper compiles each candidate pattern for the FPGA (~3 h) and runs the
app's sample benchmark.  Here a pattern runs eagerly on the program's
device; the *structure* (bounded number of measured patterns,
best-of-measured selection) is identical.

PyTorch has no ahead-of-time compile step to split off, so:

* ``compile_seconds`` is the wall time of the first, synchronized call —
  it pays every one-off cost of the pattern: the CUDA kernels' ``nvcc``
  build and load on first use, allocator warm-up, the first launches;
* ``run_seconds`` is the median of the timed reps.  On a CUDA device each
  rep is bracketed by ``torch.cuda.Event(enable_timing=True)`` records after
  a ``torch.cuda.synchronize()``; on the CPU it is ``time.perf_counter``
  (monotonic — ``time.time`` can jump under clock adjustments).

``MeasurementLedger`` is the in-run analogue of the persistent plan cache:
search strategies propose offload patterns through it, a pattern re-proposed
within one plan run is served from the ledger, and only ledger *misses*
consume the measurement budget ``d``.  Measurement is serial: the
concurrent verification executor is not ported.
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

from repro_torch.core.regions import Impl, canonical_gene, gene_variant


@dataclass
class Measurement:
    pattern: str
    compile_seconds: float      # the first, synchronized call
    run_seconds: float          # median of the kept reps
    runs: list[float]
    ok: bool = True
    error: str = ""
    # structured offload pattern {region -> variant}; `pattern` is only its
    # human-readable rendering
    impl: dict | None = None
    # on failure: the classify_failure() verdict and the phase that died
    # ("first call" or "run")
    failure_kind: str = ""
    failure_phase: str = ""
    outliers_rejected: int = 0   # timed reps dropped by MAD rejection

    def mapping(self) -> dict:
        """The measured {region -> variant} mapping (empty = all-ref)."""
        return dict(self.impl) if self.impl else {}


# ---------------------------------------------------------------------------
# Failure classification and outlier rejection
# ---------------------------------------------------------------------------
# Error-message markers that make a failure *transient* — the environment
# failed, a retry of the same measurement may succeed.  Everything else
# (shape/type errors, kernel build failures, non-finite outputs) is
# permanent: repeat offenders are quarantined.
TRANSIENT_MARKERS = (
    "OutOfMemory",               # torch.OutOfMemoryError
    "out of memory",             # the allocator's and the driver's message
)


def classify_failure(error: str) -> str:
    """``"transient"`` or ``"permanent"`` for a measurement error string.

    Transient = the environment failed (device memory exhausted, e.g. by
    another process): retrying the identical measurement may succeed.
    Permanent = the *pattern* failed (it does not run on these arguments,
    its kernel does not build, it produces NaN/Inf): retrying is wasted
    budget, so permanent failures strike the pattern's genes in the
    :class:`Quarantine` instead."""
    err = str(error or "")
    if not err:
        return "permanent"
    if "NonFiniteOutput" in err:
        return "permanent"
    return ("transient" if any(m in err for m in TRANSIENT_MARKERS)
            else "permanent")


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


def time_callable(fn, args, *, warmup: int = 1, reps: int = 5,
                  pattern: str = "", impl: dict | None = None,
                  check_finite: bool = False,
                  outlier_mad: float = 0.0,
                  remeasure: int = 0) -> Measurement:
    """Measure one offload pattern: the first synchronized call (its wall
    time is ``compile_seconds``), ``warmup - 1`` more calls, then ``reps``
    timed calls; ``run_seconds`` is the median of the kept reps.  Timing
    runs on the device of ``args``' tensors (CUDA events on a card).

    * ``check_finite`` fails the measurement (permanent ``NonFiniteOutput``)
      when the first call produces NaN/Inf — a numerically-broken offload
      must never win on speed.
    * ``outlier_mad > 0`` rejects timed reps whose modified z-score exceeds
      the threshold, re-measures up to ``remeasure`` replacement reps, and
      reports the median of the kept reps; ``runs`` keeps every raw rep and
      ``outliers_rejected`` the count.

    Never raises: a failure is a Measurement with ``ok=False``."""
    impl = dict(impl) if impl is not None else None
    dev = _device_of(args)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def timed_rep() -> float:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            sync()
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t

    def failed(phase: str, error: str, compile_s: float) -> Measurement:
        return Measurement(pattern, compile_s, float("inf"), [], False, error,
                           impl=impl, failure_kind=classify_failure(error),
                           failure_phase=phase)

    with torch.cuda.device(dev) if cuda else contextlib.nullcontext():
        t0 = time.perf_counter()
        try:
            sync()
            out = fn(*args)
            sync()
        except Exception as e:  # noqa: BLE001 — a pattern failing = not a solution
            return failed("first call", f"{type(e).__name__}: {e}",
                          time.perf_counter() - t0)
        compile_s = time.perf_counter() - t0
        if check_finite and _nonfinite(out):
            return failed("run", "NonFiniteOutput: pattern produced NaN/Inf",
                          compile_s)
        del out
        try:
            for _ in range(max(warmup - 1, 0)):
                fn(*args)
            runs = [timed_rep() for _ in range(reps)]
            rejected = 0
            kept = runs
            if outlier_mad and outlier_mad > 0 and len(runs) >= 3:
                kept, rejected = _mad_reject(runs, outlier_mad)
                # bounded re-measurement: replace (some of) the rejected
                # reps, then re-filter the full raw set once
                for _ in range(min(rejected, max(int(remeasure), 0))):
                    runs.append(timed_rep())
                if rejected:
                    refiltered, rejected = _mad_reject(runs, outlier_mad)
                    kept = refiltered if refiltered else kept
        except Exception as e:  # noqa: BLE001 — a pattern failing = not a solution
            return failed("run", f"{type(e).__name__}: {e}", compile_s)
    return Measurement(pattern, compile_s, float(np.median(kept)), runs,
                       impl=impl, outliers_rejected=rejected)


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
    planner filters it from the Step-3 ranking and strategies stop
    proposing it (:meth:`SearchState.gene_allowed`).  Records round-trip
    through :class:`~repro_torch.core.plan_cache.PlanCache` entries under
    ``measurement_key`` so future runs skip known-bad genes without
    re-paying their failures.
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
        newly: list[str] = []
        with self._lock:
            for region, gene in sorted(m.mapping().items()):
                if gene_variant(gene) == "ref":
                    continue
                gid = self.gene_id(region, gene)
                n = self._strikes.get(gid, 0) + 1
                self._strikes[gid] = n
                self._errors[gid] = str(m.error)
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
    """In-run measurement memo with the budget attached (serial).

    ``measure(impl)`` returns the cached Measurement on a hit (free), runs
    ``measure_fn`` and decrements ``budget`` on a miss, and returns ``None``
    once the budget is exhausted.  ``order`` is the measured (miss) sequence
    — exactly the patterns that consumed budget, in measurement order.

    ``measure_batch(impls)`` is the batched ask: every hit (including an
    in-batch duplicate) is served free, misses consume budget *in batch
    order* until it runs out (``None`` for the unaffordable tail).

    ``prime`` seeds an entry that never bills against ``d``: the all-ref
    baseline (the paper's pre-existing CPU system), and measurements
    recovered from previous runs of the same program on the same backend.

    ``served`` is every distinct Measurement handed to the strategy this
    run, hits and misses alike, in first-served order — the set the planner
    selects the winner from.
    """
    measure_fn: Callable
    budget: int
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

    def prime(self, impl, measurement: Measurement) -> None:
        """Record a measurement taken outside the budget (the all-ref
        baseline, or a measurement persisted by a previous plan run)."""
        k = impl_key(impl)
        self._entries[k] = measurement
        self._primed.add(k)

    def exhausted(self) -> bool:
        return self.budget <= 0

    def reused(self) -> list[Measurement]:
        """Primed (cross-run / baseline) measurements the strategy actually
        re-proposed this run — served for free."""
        return [m for m in self.served
                if impl_key(m.impl or {}) in self._primed]

    def _serve(self, key: tuple, m: Measurement) -> Measurement:
        if key not in self._served_keys:
            self._served_keys.add(key)
            self.served.append(m)
        return m

    def measure(self, impl) -> Optional[Measurement]:
        k = impl_key(impl)
        hit = self._entries.get(k)
        if hit is not None:
            self.hits += 1
            return self._serve(k, hit)
        if self.budget <= 0:
            return None
        m = self.measure_fn(impl)
        self.budget -= 1
        self.misses += 1
        self._entries[k] = m
        self.order.append(m)
        if self.quarantine is not None and not m.ok:
            self.quarantine.record(m)
        return self._serve(k, m)

    def measure_batch(self, impls) -> list[Optional[Measurement]]:
        """Batched ask: one ``Optional[Measurement]`` per input, in order."""
        return [self.measure(impl) for impl in impls]
