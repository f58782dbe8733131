"""Online replanning: drift detection + background re-search + zero-downtime
plan hot-swap for the serving engine (the port of the JAX package's
``serving/replan.py``).

The paper's pipeline picks an offload pattern once, under the measurement
conditions known at plan time.  A serving environment keeps moving after
that — bucket mix, slot occupancy, decode/prefill balance — so the pattern
that won the verification environment can stop being the right one.  This
module closes the loop (ROADMAP "online replanning"):

1. **Drift detection** (``DriftDetector``): the windowed in-flight
   ``engine.stats(window=N)`` view is folded into a regime fingerprint
   (normalized bucket mix, mean occupancy, decode/prefill ratio) and
   compared against the regime the current plan was made for.  Configurable
   thresholds plus a consecutive-observation hysteresis and a post-fire
   cooldown keep it from flapping on a noisy boundary.

2. **Background re-search** (``Replanner``): when a trigger fires (drift,
   or a fixed ``every_ticks`` interval), the planner re-opens the Step-4
   search on a worker thread while the engine keeps ticking.  The
   ``plan_fn`` the replanner calls goes through the ordinary
   ``AutoOffloader.plan(..., cache=...)`` path, so PR-4/PR-5 reuse applies
   unchanged: sibling plan-cache entries with the same measurement key
   prime the ledger (re-proposed known patterns cost zero budget), the
   persisted CostModel state pre-calibrates the surrogate, and a long-lived
   ``AutoOffloader`` keeps its ``CompileCache`` warm across replans.  The
   search times each pattern on a stream of its own
   (``search.time_callable``), never by a whole-device sync that would
   wait on (and count) the ticks.

3. **Atomic hot-swap**: a strictly-better winner is built off-thread
   (``engine.prepare_plan`` — on a card its CUDA graphs are captured on the
   worker's side stream into a pool of their own), canary-validated
   (``engine.canary_check`` — no exception, finite logits, and bit-equal to
   the serving plan where both run the same decode arithmetic, within the
   stated noise tolerance where they do not) and only then staged with
   ``engine.offer_plan``; the engine installs it between ticks under the
   generation counter.  No request is dropped or re-queued, no tick blocks
   on search or capture, and token streams are unchanged for
   numerics-identical patterns.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core.planner import conditions_from_stats
from repro_torch.core.search import impl_key


@dataclass(frozen=True)
class DriftConfig:
    """Thresholds and damping for the drift detector.

    * ``window`` (int, 32) — engine ticks the regime fingerprint averages
      over (``engine.stats(window=...)``).
    * ``bucket_l1`` (float, 0.6) — L1 distance between normalized prefill
      bucket mixes (0 = identical, 2 = disjoint) above which the bucket
      signal counts as drifted.
    * ``occupancy_delta`` (float, 0.3) — absolute change in mean slot
      occupancy (0..1) above which the occupancy signal counts as drifted.
    * ``ratio_rel`` (float, 1.0) — relative change in the decode/prefill
      ratio above which the workload-balance signal counts as drifted;
      ratios below ``ratio_floor`` on both sides are never compared (an
      idle engine has no meaningful balance).
    * ``hysteresis`` (int, 2) — consecutive drifted observations required
      before the detector fires; a single noisy window never triggers a
      replan.
    * ``cooldown`` (int, 64) — ticks after a fire (or an anchor reset)
      during which observations are ignored, so one sustained regime shift
      produces one replan, not a burst.
    """
    window: int = 32
    bucket_l1: float = 0.6
    occupancy_delta: float = 0.3
    ratio_rel: float = 1.0
    ratio_floor: float = 0.5
    hysteresis: int = 2
    cooldown: int = 64


class DriftDetector:
    """Fires when the live serving regime leaves the planned one.

    ``anchor(stats, tick)`` pins the reference regime (call it when a plan
    is made for the current conditions); ``observe(stats, tick)`` returns
    True when the fingerprint has stayed out of the anchored regime for
    ``hysteresis`` consecutive observations outside the cooldown.  The last
    computed per-signal distances are kept in ``last_distance`` for
    observability."""

    def __init__(self, config: DriftConfig = DriftConfig()):
        self.config = config
        self._anchor: Optional[dict] = None
        self._streak = 0
        self._cooldown_until = -1
        self.fired = 0
        self.last_distance: dict = {}

    @staticmethod
    def regime(stats: dict) -> dict:
        """The regime fingerprint of a windowed stats view: normalized
        bucket mix, mean occupancy, decode/prefill ratio."""
        hist = {int(b): float(c)
                for b, c in dict(stats.get("bucket_hist", {})).items()}
        total = sum(hist.values())
        mix = ({b: c / total for b, c in hist.items()} if total else {})
        return {
            "bucket_mix": mix,
            "occupancy": float(stats.get("occupancy_mean", 0.0)),
            "ratio": float(stats.get("decode_prefill_ratio", 0.0)),
        }

    def anchor(self, stats: dict, tick: int = 0) -> None:
        """Pin the reference regime and restart hysteresis + cooldown."""
        self._anchor = self.regime(stats)
        self._streak = 0
        self._cooldown_until = tick + self.config.cooldown

    def distances(self, stats: dict) -> dict:
        """Per-signal distances of ``stats`` from the anchored regime."""
        cur = self.regime(stats)
        ref = self._anchor or cur
        keys = set(cur["bucket_mix"]) | set(ref["bucket_mix"])
        bucket_l1 = sum(abs(cur["bucket_mix"].get(k, 0.0)
                            - ref["bucket_mix"].get(k, 0.0)) for k in keys)
        occupancy = abs(cur["occupancy"] - ref["occupancy"])
        r, r0 = cur["ratio"], ref["ratio"]
        if max(r, r0) < self.config.ratio_floor:
            ratio = 0.0            # both near-idle: balance is meaningless
        else:
            ratio = abs(r - r0) / max(r0, 1e-9)
        return {"bucket_l1": bucket_l1, "occupancy": occupancy,
                "ratio": ratio}

    def observe(self, stats: dict, tick: int) -> bool:
        """One windowed observation; True when the detector fires."""
        if self._anchor is None:
            self.anchor(stats, tick)
            return False
        if tick < self._cooldown_until:
            return False
        d = self.distances(stats)
        self.last_distance = d
        cfg = self.config
        drifted = (d["bucket_l1"] > cfg.bucket_l1
                   or d["occupancy"] > cfg.occupancy_delta
                   or d["ratio"] > cfg.ratio_rel)
        self._streak = self._streak + 1 if drifted else 0
        if self._streak >= cfg.hysteresis:
            self.fired += 1
            self._streak = 0
            self._cooldown_until = tick + cfg.cooldown
            return True
        return False


@dataclass(frozen=True)
class ReplanConfig:
    """Replanner triggers and swap policy.

    * ``every_ticks`` (int, 0) — re-plan on a fixed tick interval; 0
      disables the timer (drift-only).
    * ``on_drift`` (bool, False) — attach a ``DriftDetector`` (with default
      ``DriftConfig``) unless one was passed explicitly.
    * ``background`` (bool, True) — run the search + trace build on a
      daemon worker thread (production).  False runs it inline inside
      ``on_tick`` — deterministic, for tests; the swap still lands at the
      next tick boundary.
    * ``min_speedup`` (float, 1.0) — a candidate plan must beat the
      serving plan's measured seconds by this factor to be offered
      (strictly-better gate); when the serving plan was never measured
      (e.g. arch defaults), any measured winner with a different canonical
      key is offered.
    * ``canary`` (bool, True) — validate every candidate with
      ``engine.canary_check`` (see its rule) before ``offer_plan``; a
      rejected candidate's key is never offered again and its non-ref
      genes are reported to the shared quarantine.
    * ``window`` (int, 32) — ticks of windowed stats fed to
      ``conditions_from_stats`` and the detector.
    """
    every_ticks: int = 0
    on_drift: bool = False
    background: bool = True
    min_speedup: float = 1.0
    canary: bool = True
    window: int = 32


class Replanner:
    """Drives online replanning for ONE engine (attach via
    ``engine.attach_replanner``).

    ``plan_fn(conditions) -> PlanReport`` is the pluggable search entry
    point: production wires it to ``AutoOffloader.plan`` over
    ``make_lm_program(..., plan_extra=conditions)`` (see
    ``launch/serve.py::make_replan_fn``) so regime conditions re-key the
    plan cache while
    ledger priming keeps warm re-opens at zero measurement budget; tests
    substitute cheap toy programs or scripted reports.

    Counters: ``replans`` (searches completed), ``offers`` (strictly-better
    plans staged), ``skipped_same``/``skipped_slower``/``skipped_rejected``
    (searches whose winner didn't earn a swap), ``canary_rejects`` (winners
    the canary vetoed), ``plan_faults`` (engine rollbacks reported back via
    ``on_plan_fault``); ``last_report``/``last_conditions``/``last_error``/
    ``last_canary_reason`` (the canary's verdict, accepted or not) expose
    the most recent search for tests and telemetry.

    ``quarantine`` (optional, a ``core.search.Quarantine``) receives the
    non-ref genes of every canary-rejected or runtime-faulted plan — share
    the instance with the ``AutoOffloader`` behind ``plan_fn`` and the
    search stops proposing those genes on the very next replan.

    The background worker thread is joined by ``close()`` (also a context
    manager): a closed replanner ignores further ticks, so the thread can
    never outlive the serving loop that owns it.
    """

    def __init__(self, plan_fn: Callable[[dict], object], *,
                 config: ReplanConfig = ReplanConfig(),
                 detector: Optional[DriftDetector] = None,
                 quarantine=None):
        self.plan_fn = plan_fn
        self.config = config
        self.detector = detector
        if self.detector is None and config.on_drift:
            self.detector = DriftDetector(DriftConfig(window=config.window))
        self.quarantine = quarantine
        self._busy = False
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._last_trigger_tick = -(10 ** 9)
        self.replans = 0
        self.offers = 0
        self.skipped_same = 0
        self.skipped_slower = 0
        self.skipped_rejected = 0
        self.canary_rejects = 0
        self.plan_faults = 0
        self._rejected_keys: set = set()
        self.last_report = None
        self.last_conditions: Optional[dict] = None
        self.last_trigger: Optional[str] = None
        self.last_error: Optional[BaseException] = None
        self.last_canary_reason: Optional[str] = None

    def attach(self, engine) -> None:
        """Called by ``engine.attach_replanner``; nothing to do eagerly —
        the detector anchors itself on its first observation."""

    # ------------------------------------------------------------------
    def on_tick(self, engine) -> None:
        """Trigger evaluation, called by the engine after every tick.  Never
        searches or compiles inline (unless ``background=False``): it reads
        the windowed stats, consults the triggers, and hands the slow work
        to a worker thread."""
        if self._busy or self._closed:
            return
        stats = engine.stats(window=self.config.window)
        trigger = None
        if (self.config.every_ticks
                and engine.ticks - self._last_trigger_tick
                >= self.config.every_ticks):
            trigger = "interval"
        if (self.detector is not None and stats["ticks_observed"] > 0
                and self.detector.observe(stats, engine.ticks)):
            trigger = "drift"
        if trigger is None:
            return
        self._last_trigger_tick = engine.ticks
        self._busy = True
        if self.config.background:
            self._thread = threading.Thread(
                target=self._replan, args=(engine, stats, trigger),
                name="serve-replan", daemon=True)
            self._thread.start()
        else:
            self._replan(engine, stats, trigger)

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for an in-flight background replan (tests / shutdown)."""
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)

    def close(self, timeout: float = 10.0) -> None:
        """Shut the replanner down: refuse further triggers, then join any
        in-flight background replan.  A worker that outlives ``timeout`` is
        abandoned (it is a daemon thread) and recorded in ``last_error`` —
        the owner surfaces it rather than hanging shutdown forever.
        Idempotent; also available as a context manager."""
        self._closed = True
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
            if t.is_alive():
                self.last_error = TimeoutError(
                    f"background replan still running after {timeout:.1f}s; "
                    "daemon thread abandoned")

    def __enter__(self) -> "Replanner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    def on_plan_fault(self, impl, reason: str) -> None:
        """Engine callback: ``impl`` faulted on the tick path and was rolled
        back.  Its key is permanently refused (never offered again) and its
        non-ref genes go to the shared quarantine so the next search stops
        proposing them."""
        self._rejected_keys.add(impl_key(impl))
        self.plan_faults += 1
        if self.quarantine is not None:
            self.quarantine.record_failure(impl, reason)

    def _quarantine_impl(self, impl, reason: str) -> None:
        if self.quarantine is not None:
            self.quarantine.record_failure(impl, reason)

    # ------------------------------------------------------------------
    def _replan(self, engine, stats: dict, trigger: str) -> None:
        """Search + trace build, off the tick path.  Offers the winner only
        when it is strictly better than the serving plan."""
        try:
            conditions = conditions_from_stats(stats)
            report = self.plan_fn(conditions)
            self.replans += 1
            self.last_report = report
            self.last_conditions = conditions
            self.last_trigger = trigger
            best_seconds = float(getattr(report, "best_seconds", 0.0) or 0.0)
            prepared = engine.prepare_plan(
                report.best_impl(),
                plan_seconds=best_seconds if best_seconds > 0 else None)
            current_seconds = engine.plan_seconds
            if prepared.key == engine.plan_key:
                self.skipped_same += 1
            elif prepared.key in self._rejected_keys:
                self.skipped_rejected += 1
            elif (current_seconds is not None and best_seconds > 0
                    and best_seconds * self.config.min_speedup
                    >= current_seconds):
                self.skipped_slower += 1
            elif self.config.canary and hasattr(engine, "canary_check"):
                ok, reason = engine.canary_check(prepared)
                self.last_canary_reason = reason
                if ok:
                    engine.offer_plan(prepared)
                    self.offers += 1
                else:
                    # a canary-vetoed plan is permanently refused and its
                    # genes reported to the shared quarantine — the next
                    # search will not re-propose them
                    self.canary_rejects += 1
                    self._rejected_keys.add(prepared.key)
                    self._quarantine_impl(prepared.impl, reason)
            else:
                engine.offer_plan(prepared)
                self.offers += 1
            # the regime just searched IS the planned regime now — re-anchor
            # so the detector measures drift from it, not from boot time
            if self.detector is not None:
                self.detector.anchor(stats, engine.ticks)
        except BaseException as e:  # noqa: BLE001 — a failed background
            self.last_error = e     # search must never kill the serving loop
            if not self.config.background:
                raise
        finally:
            self._busy = False

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Replanning telemetry counters."""
        return {
            "replans": self.replans,
            "offers": self.offers,
            "skipped_same": self.skipped_same,
            "skipped_slower": self.skipped_slower,
            "skipped_rejected": self.skipped_rejected,
            "canary_rejects": self.canary_rejects,
            "plan_faults": self.plan_faults,
            "detector_fired": self.detector.fired if self.detector else 0,
            "busy": self._busy,
        }
