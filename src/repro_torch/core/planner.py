"""The paper's automatic loop-offload planner (§3.3, Fig. 2), in PyTorch,
extended to mixed offload destinations (Yamato, arXiv 2011.12431).

  Step 1  code analysis        — region census + loop census (fori_loop
                                 statements of one all-ref run on meta
                                 tensors)
  Step 2  AI filter            — arithmetic intensity per region, keep top-a
  Step 3  resource filter      — a meta-tensor run of EVERY registered
                                 offload variant of each surviving region ->
                                 on-chip memory fraction (shared memory per
                                 block for hand-written kernels, L2 for plain
                                 PyTorch); efficiency = AI / fraction; rank
                                 (region, variant) pairs, keep the top-c
                                 regions (each with its variant ranking)
  Step 4  measured search      — a pluggable ``SearchStrategy``
                                 (core/strategies.py) proposes patterns
                                 ask–tell through a ``MeasurementLedger``;
                                 total measured patterns <= d, no pattern
                                 measured twice (the all-ref baseline is the
                                 pre-existing reference and costs nothing)
  Step 5  select               — fastest measured pattern

Step 4 verifies through the ``VerificationExecutor`` (core/executor.py):
each pattern's host-only compile step (the ``nvcc`` builds its ``hopper``
genes need, then ``program.build``) may run concurrently on a worker pool,
while every first call, capture and timed rep runs serially on the
program's device (``program.device``) under the ``FaultPolicy`` (timeouts,
bounded retry, finite check, MAD rejection).  On a card each pattern, the
all-ref baseline among them, is captured once into a CUDA graph and its
replays are timed (``core/search.py``), as the JAX package times one
compiled executable; on the CPU its calls run eagerly.  A plan's summary
says which after each pattern's first call (``timed as graph`` or
``timed as eager``).  The surrogate strategy scores patterns with
the roofline ``CostModel`` (core/cost_model.py), primed from the plan
cache's persisted calibration.

Plans are cacheable: ``plan(..., cache=...)`` consults/updates a persistent
``PlanCache`` keyed by program name + abstract arg shapes/dtypes + variant
registry + backend (the torch device) + planner config.

Defaults a=5, c=3, d=4 match the paper's evaluation conditions (§5.1.2).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field

from repro_torch.core import search
from repro_torch.core.cost_model import CostModel
from repro_torch.core.device import backend_name
from repro_torch.core.executor import (CompileCache, FaultPolicy,
                                       VerificationExecutor, VerifyJob,
                                       compile_key, measure_with_retry)
from repro_torch.core.intensity import RegionAnalysis, analyze_region, count_loops
from repro_torch.core.plan_cache import (PlanCache, measurement_cache_key,
                                         plan_cache_key, resolve_cache)
from repro_torch.core.program import OffloadableProgram
from repro_torch.core.regions import (BoundTuningSpace, Impl, offload_variants,
                                      tuning_space)
from repro_torch.core.resources import ResourceEstimate, precompile_many
from repro_torch.core.search import Measurement, MeasurementLedger
from repro_torch.core.strategies import SearchCandidate, SearchState, make_strategy


@dataclass(frozen=True)
class PlannerConfig:
    """Every knob of the automatic offload planner (the JAX package's, less
    its Pallas unroll knob ``unroll_b``).

    All fields except ``reps``/``warmup`` and the fault-tolerance knobs
    participate in the plan-cache key; ``seed`` and the ``ga_*`` knobs
    participate only for strategies that read them (``genetic``,
    ``surrogate``, ``auto``).

    Pipeline budgets (paper §5.1.2 defaults):

    * ``top_a`` (5) — Step-2 arithmetic-intensity filter width.
    * ``top_c`` (3) — Step-3 resource-efficiency filter width.
    * ``max_measurements`` (4) — the paper's ``d``: Step-4 patterns that may
      consume real measurements (ledger hits are free).
    * ``resource_cap`` (1.0) — summed on-chip-memory fraction a combined
      pattern may claim; over-cap patterns are never built.
    * ``tune_tiles`` (False) — widen the genome to ``(variant, tile
      params)`` for variants that declared a ``TuningSpace``.

    Measurement fidelity (not in the key): ``warmup`` (1) / ``reps`` (5).

    Fault tolerance (not in the key — they govern how the environment's
    failures are survived, never which pattern is best):

    * ``compile_timeout_s`` (0.0) — wall ceiling per compile step; 0 = off.
    * ``run_timeout_s`` (0.0) — wall ceiling per call (first, warm-up, each
      timed rep); 0 = off.  After an expiry the device is drained.
    * ``max_retries`` (2) / ``retry_backoff_s`` (0.05) — bounded retry with
      exponential backoff for transient failures.
    * ``outlier_mad`` (3.5) / ``remeasure`` (2) — MAD outlier rejection
      over the timed reps (0 disables).
    * ``quarantine_threshold`` (2) — permanent failures that quarantine a
      gene; strikes persist in the plan cache under ``measurement_key``.

    Step-4 search strategy (core/strategies.py):

    * ``strategy`` ("staged") — staged | genetic | surrogate | exhaustive |
      auto.
    * ``seed`` (0) — strategy RNG seed (GA determinism).
    * ``ga_population`` (6), ``ga_generations`` (4), ``ga_crossover``
      (0.9), ``ga_mutation`` (0.15), ``ga_tournament`` (2), ``ga_elite``
      (1) — the GA; ``ga_topk`` (2) — surrogate only: real measurements per
      generation.

    Verification executor (core/executor.py):

    * ``verify_workers`` (1) — thread-pool width for the concurrent compile
      steps of Steps 3 and 4 (timed reps stay serial at any width; the
      measured sequence and the selected pattern are the same for every
      value).  In the key, so pipelined and serial plans stay
      distinguishable.
    """
    top_a: int = 5              # AI filter width (paper: 5)
    top_c: int = 3              # resource-efficiency filter width (paper: 3)
    max_measurements: int = 4   # d (paper: 4)
    resource_cap: float = 1.0   # summed on-chip fraction cap for combinations
    tune_tiles: bool = False    # search (variant, tile params) genes

    warmup: int = 1
    reps: int = 5
    # ---- fault tolerance (core/executor.py FaultPolicy; not in the key) ----
    compile_timeout_s: float = 0.0   # per-compile watchdog wall (0 = off)
    run_timeout_s: float = 0.0       # per-call watchdog wall (0 = off)
    max_retries: int = 2             # bounded retries for transient failures
    retry_backoff_s: float = 0.05    # exponential-backoff base between tries
    outlier_mad: float = 3.5         # modified-z rep rejection (0 = off)
    remeasure: int = 2               # replacement reps after rejection
    quarantine_threshold: int = 2    # permanent-failure strikes per gene
    # ---- Step-4 search strategy (core/strategies.py) ----
    strategy: str = "staged"    # staged | genetic | surrogate | exhaustive | auto
    seed: int = 0               # strategy RNG seed (GA determinism)
    ga_population: int = 6      # genomes per generation
    ga_generations: int = 4     # generations (ledger hits don't spend d)
    ga_crossover: float = 0.9   # uniform-crossover probability
    ga_mutation: float = 0.15   # per-gene mutation probability
    ga_tournament: int = 2      # tournament size
    ga_elite: int = 1           # elites carried over (re-measured for free)
    ga_topk: int = 2            # surrogate: real measurements per generation
    # ---- verification executor (core/executor.py) ----
    verify_workers: int = 1     # concurrent compile threads (1 = serial)


def conditions_from_stats(stats: dict) -> dict:
    """Fold a ServeEngine windowed stats view (``engine.stats(window=N)``)
    into discrete measurement conditions for online replanning.

    Deliberately coarse — a plan-cache key ingredient
    (``OffloadableProgram.plan_extra``), not a telemetry dump: banding keeps
    neighboring windows of the same regime on the same conditions, while a
    real regime shift re-opens the search.  Keys:

    * ``dominant_bucket`` — the prefill bucket with the most admissions in
      the window (ties favor the longer bucket; 0 when nothing admitted),
    * ``occupancy_band`` — mean slot occupancy in thirds: low / mid / high,
    * ``decode_prefill_band`` — ``floor(log2(1 + decode/prefill ratio))``.

    Deterministic: equal stats give equal conditions."""
    hist = {int(b): int(c)
            for b, c in dict(stats.get("bucket_hist", {})).items()}
    dominant = (max(hist.items(), key=lambda kv: (kv[1], kv[0]))[0]
                if hist else 0)
    occ = float(stats.get("occupancy_mean", 0.0))
    occupancy_band = "low" if occ < 1 / 3 else ("mid" if occ < 2 / 3 else "high")
    ratio = max(float(stats.get("decode_prefill_ratio", 0.0)), 0.0)
    return {
        "dominant_bucket": dominant,
        "occupancy_band": occupancy_band,
        "decode_prefill_band": int(math.floor(math.log2(1.0 + ratio))),
    }


def _efficiency(analysis: RegionAnalysis,
                resources: ResourceEstimate | None) -> float:
    """The paper's resource efficiency: AI per unit of claimed resources."""
    if resources is None or not resources.lower_ok:
        return 0.0
    return analysis.arithmetic_intensity / max(
        resources.resource_fraction, 1e-6)


@dataclass
class VariantCandidate:
    """One (region, variant) offload destination candidate."""
    region: str
    variant: str
    analysis: RegionAnalysis
    resources: ResourceEstimate

    @property
    def efficiency(self) -> float:
        return _efficiency(self.analysis, self.resources)


@dataclass
class CandidateInfo:
    """Per-region analysis summary (Step 2 unit; Step 3 fans out to
    VariantCandidates, the best of which is mirrored here for reporting)."""
    region: str
    analysis: RegionAnalysis
    resources: ResourceEstimate | None = None      # best variant's estimate
    best_variant: str | None = None
    variant_estimates: dict[str, ResourceEstimate] = field(default_factory=dict)

    @property
    def efficiency(self) -> float:
        return _efficiency(self.analysis, self.resources)


@dataclass
class PlanReport:
    program: str
    source_loop_count: int
    loop_count: int                    # Step-1 census of the all-ref build
    backend: str = ""
    candidates: list[CandidateInfo] = field(default_factory=list)
    ai_selected: list[str] = field(default_factory=list)       # after Step 2
    eff_selected: list[str] = field(default_factory=list)      # after Step 3
    eff_pairs: list[tuple[str, str]] = field(default_factory=list)
    baseline: Measurement | None = None
    measurements: list[Measurement] = field(default_factory=list)
    best_pattern: dict = field(default_factory=dict)
    speedup: float = 0.0
    best_seconds: float = 0.0          # winning measurement's own median
    skipped_combinations: list[str] = field(default_factory=list)
    from_cache: bool = False
    cache_key: str = ""
    strategy: str = "staged"           # which SearchStrategy produced this
    search_trace: list[dict] = field(default_factory=list)
    # patterns served from plan-cache priming (zero budget spent), and the
    # size of the Step-3 survivor genome space
    reused: list[Measurement] = field(default_factory=list)
    search_space: int = 0
    # verification-executor wall-clock accounting: verify_wall_s is the
    # wall of the batched Step-4 verification phases (compile + timed reps),
    # compile_wall_s the part the serial pipeline was BLOCKED on compiles —
    # with workers > 1 it shrinks toward the longest compile per batch
    verify_workers: int = 1
    verify_wall_s: float = 0.0
    compile_wall_s: float = 0.0
    # the search's final CostModel calibration (export_state), persisted
    # next to the measurements so re-opened searches start calibrated
    cost_model_state: dict = field(default_factory=dict)
    quarantined: list[str] = field(default_factory=list)
    quarantine_records: list[dict] = field(default_factory=list)

    def best_impl(self) -> Impl:
        """The selected pattern as a dispatchable Impl."""
        return Impl(self.best_pattern)

    def summary(self) -> str:
        lines = [f"== offload plan: {self.program} on {self.backend} =="
                 + ("  [served from plan cache]" if self.from_cache else "")]
        lines += [f"loops: source={self.source_loop_count} "
                  f"traced={self.loop_count}",
                  f"search strategy: {self.strategy}",
                  f"AI top-a: {self.ai_selected}",
                  f"efficiency top-c: {self.eff_selected}"]
        if self.eff_pairs:
            lines.append("ranked destinations: "
                         + ", ".join(f"{r}={v}" for r, v in self.eff_pairs))
        for c in self.candidates:
            res = c.resources
            lines.append(
                f"  {c.region:18s} AI={c.analysis.arithmetic_intensity:10.2f} "
                f"flops={c.analysis.weighted_flops:.3e} "
                f"mem_frac={res.resource_fraction if res else float('nan'):8.4f} "
                f"eff={c.efficiency:10.1f}"
                + (f" best_variant={c.best_variant}" if c.best_variant else ""))
        if self.baseline:
            b = self.baseline
            lines.append(f"baseline (all-ref): {b.run_seconds*1e3:.3f} ms"
                         f"  (first call {b.first_run_seconds*1e3:.0f} ms"
                         + (f", timed as {b.timed_as})" if b.ok else ")"))
        for m in self.measurements:
            lines.append(f"  pattern[{m.pattern}]: {m.run_seconds*1e3:.3f} ms"
                         f"  (compile {m.compile_seconds*1e3:.0f} ms, first "
                         f"call {m.first_run_seconds*1e3:.0f} ms"
                         + (f", timed as {m.timed_as})" if m.ok else ")")
                         + (f"  [{m.attempts} attempts]" if m.attempts > 1 else "")
                         + ("  [device drained after a timeout]"
                            if m.drained else "")
                         + ("" if m.ok else f"  FAILED [{m.failure_kind or '?'}]"
                            f" {m.error}"))
        if self.quarantined:
            lines.append("quarantined genes: " + ", ".join(self.quarantined))
        for m in self.reused:
            lines.append(f"  pattern[{m.pattern}]: {m.run_seconds*1e3:.3f} ms"
                         f"  [reused from plan cache, zero budget]")
        for t in self.search_trace:
            if "pairs" in t:          # cost-model pair-bias notes
                lines.append(f"  {t.get('stage', '?')}: " + "; ".join(
                    f"{'+'.join('='.join(g) for g in p['pair'])} "
                    f"{p['sign']} x{p['observations']} "
                    f"(mean {p['mean_rel_residual']:+.1%})"
                    for p in t["pairs"]))
                continue
            if "workers" in t:        # verification-executor accounting
                lines.append(
                    f"  {t.get('stage', '?')}: workers={t['workers']} "
                    f"batches={t.get('batches', 0)} "
                    f"compile_wall={t.get('compile_wall_s', 0.0)*1e3:.0f} ms "
                    f"(of {t.get('compile_seconds_total', 0.0)*1e3:.0f} ms "
                    f"compiled) verify_wall="
                    f"{t.get('verify_wall_s', 0.0)*1e3:.0f} ms "
                    f"cache_hits={t.get('compile_cache_hits', 0)}"
                    + (f" drained={t['drained']}" if t.get("drained") else ""))
                continue
            # the trace line adds the stage grouping and the proposal count
            # (which includes free ledger hits, e.g. GA elites)
            n = len(t.get("patterns", []))
            line = (f"  {t.get('stage', '?')}: "
                    f"{n} proposal{'s' if n != 1 else ''}")
            if t.get("model_error") is not None:
                line += (f"  (surrogate error "
                         f"{t['model_error'] * 100:.1f}%)")
            lines.append(line)
        lines.append(f"best: {self.best_pattern}  speedup={self.speedup:.2f}x")
        return "\n".join(lines)


class AutoOffloader:
    def __init__(self, config: PlannerConfig = PlannerConfig(),
                 quarantine: search.Quarantine | None = None):
        self.config = config
        # offloader-lifetime compile memo: a pattern built once for a
        # (program, shapes) pair is never built again by this instance
        self.compile_cache = CompileCache()
        # offloader-lifetime strike list.  An external instance may be
        # shared with a serving-side Replanner so a plan that faulted
        # mid-serve is filtered from every later search; per-plan-run
        # records persisted in the cache merge into it on each plan()
        self.quarantine = (quarantine if quarantine is not None
                           else search.Quarantine(
                               threshold=config.quarantine_threshold))

    # ------------------------------------------------------------------
    def plan(self, program: OffloadableProgram, seed: int = 0,
             cache: PlanCache | str | None = None) -> PlanReport:
        """Plan ``program`` on ``program.device``: run the configured
        Step-4 search strategy, or serve the plan from ``cache``.

        ``seed`` draws the sample inputs (it does NOT enter the cache key).
        Every pattern is timed on a stream of its own with CUDA events, so
        a plan may run while the device serves other work (a serving
        engine ticking on another thread, as under the online replanner).
        ``cache`` is a ``PlanCache``, a path, or None (no caching):

        * **hit** — an entry matches the full plan key: the stored plan is
          returned with zero new measurements (``from_cache=True``);
        * **primed miss** — sibling entries measured under the same
          conditions (``measurement_cache_key``) donate their per-pattern
          measurements: the search re-runs, and every re-proposed known
          pattern is served from the ledger for free (``report.reused``);
        * **cold miss** — the full pipeline runs and the selection is
          stored (together with ALL its measurements).

        ``report.best_impl()`` is the dispatchable selected pattern.
        """
        backend = backend_name(program.device)
        store = resolve_cache(cache)
        ckey = (plan_cache_key(program, self.config, backend)
                if store is not None else "")
        if store is not None:
            entry = store.get(ckey)
            if entry is not None:
                return self._report_from_cache(program, ckey, entry, backend)
        report = self._plan_measured(program, seed, backend, store)
        report.cache_key = ckey
        if store is not None and self._sound(report):
            store.put(ckey, self._cache_entry(report, program, backend))
        return report

    @staticmethod
    def _sound(report: PlanReport) -> bool:
        """Only sound searches are cached: a failed baseline or an
        all-patterns-failed round is likely transient and must be retried
        on the next plan() instead of being served forever."""
        if report.baseline is None or not report.baseline.ok:
            return False
        if report.measurements and not any(m.ok for m in report.measurements):
            return False
        return True

    # ------------------------------------------------------------------
    def _plan_measured(self, program: OffloadableProgram, seed: int,
                       backend: str, store: PlanCache | None) -> PlanReport:
        cfg = self.config
        sample = program.sample_inputs(seed, program.device)

        # ---- Step 1: code analysis ------------------------------------
        full_ref = program.build(Impl())
        report = PlanReport(program=program.name,
                            source_loop_count=program.source_loop_count,
                            loop_count=count_loops(full_ref, *sample),
                            backend=backend)

        # ---- Step 2: arithmetic-intensity filter ----------------------
        # with the region's compile-time knobs, as Step 3 lowers it (the
        # JAX planner leaves them out, and cannot analyse a region whose
        # ref requires them, such as moe_dispatch's capacity)
        cands = [CandidateInfo(region=r.name,
                               analysis=analyze_region(
                                   functools.partial(r.analysis_fn,
                                                     **r.static_kwargs),
                                   *r.analysis_args, name=r.name))
                 for r in program.regions]
        report.candidates = cands
        by_ai = sorted(cands, key=lambda c: -c.analysis.arithmetic_intensity)
        ai_set = [c.region for c in by_ai[:cfg.top_a]]
        report.ai_selected = ai_set

        # ---- Step 3: resource filter over (region, variant) pairs -----
        # the meta runs of every (region, variant) pair fan out on the
        # verification executor (order-preserving: the ranking is the same
        # at any worker count)
        policy = FaultPolicy(compile_timeout_s=cfg.compile_timeout_s,
                             run_timeout_s=cfg.run_timeout_s,
                             max_retries=cfg.max_retries,
                             retry_backoff_s=cfg.retry_backoff_s,
                             outlier_mad=cfg.outlier_mad,
                             remeasure=cfg.remeasure)
        executor = VerificationExecutor(workers=cfg.verify_workers,
                                        cache=self.compile_cache,
                                        policy=policy)
        quarantine = self.quarantine
        mkey = measurement_cache_key(program, backend) if store is not None else ""
        if store is not None:
            quarantine.load_records(store.quarantine_for(mkey))
        try:
            return self._search(program, cfg, report, cands, ai_set, sample,
                                full_ref, executor, policy, quarantine,
                                store, mkey)
        finally:
            # idempotent; guards the pool and the offloader-lifetime
            # CompileCache against any exception from Step 3 onward
            executor.shutdown()

    def _search(self, program, cfg, report, cands, ai_set, sample, full_ref,
                executor, policy, quarantine, store, mkey) -> PlanReport:
        region_map = {r.name: r for r in program.regions}
        jobs, meta = [], []
        for c in cands:
            if c.region not in ai_set:
                continue
            r = region_map[c.region]
            for var, fn in offload_variants(c.region).items():
                jobs.append((c.region, var, fn, r.analysis_args, None,
                             r.static_kwargs))
                meta.append((c, var))
        pairs: list[VariantCandidate] = []
        for (c, var), est in zip(meta, precompile_many(
                jobs, mapper=executor.map_concurrent)):
            c.variant_estimates[var] = est
            pairs.append(VariantCandidate(c.region, var, c.analysis, est))
        eligible = [p for p in pairs if p.resources.lower_ok
                    and p.resources.resource_fraction <= cfg.resource_cap
                    and not quarantine.is_quarantined(p.region, p.variant)]

        def rank_key(p: VariantCandidate):
            # efficiency first; the region's declared deploy/measure
            # preference breaks ties
            r = region_map[p.region]
            preferred = p.variant in (r.deploy_variant, r.measure_variant)
            return (-p.efficiency, 0 if preferred else 1, p.variant)

        ranked = sorted(eligible, key=rank_key)
        variants_of: dict[str, list[VariantCandidate]] = {}
        for p in ranked:
            variants_of.setdefault(p.region, []).append(p)
        eff_regions: list[str] = []
        for p in ranked:
            if p.region not in eff_regions:
                eff_regions.append(p.region)
            if len(eff_regions) == cfg.top_c:
                break
        report.eff_selected = eff_regions
        report.eff_pairs = [(p.region, p.variant) for p in ranked
                            if p.region in eff_regions]
        for c in cands:                         # mirror best pair for reports
            best = variants_of.get(c.region, [])
            if best:
                c.best_variant = best[0].variant
                c.resources = best[0].resources
            elif c.variant_estimates:           # all failed/over-cap: show one
                c.resources = next(iter(c.variant_estimates.values()))

        # ---- Step 4: measured pattern search ---------------------------
        # the all-ref baseline goes through the same path as every
        # candidate: the same fault policy (an unlucky hiccup must not void
        # the whole search) and, on a card, the same capture into a CUDA
        # graph whose replays are timed
        report.baseline = measure_with_retry(
            lambda: (search.time_callable(
                full_ref, sample, warmup=cfg.warmup, reps=cfg.reps,
                pattern="all-ref", impl=Impl(),
                run_timeout_s=policy.run_timeout_s,
                check_finite=policy.check_finite,
                outlier_mad=policy.outlier_mad,
                remeasure=policy.remeasure), True),
            policy)

        # on the CPU a hopper wrapper runs its kernel's plain version: there
        # is nothing to build
        on_card = program.device.type == "cuda"

        def job(impl) -> VerifyJob:
            impl = Impl(impl)
            return VerifyJob(key=compile_key(program.name, impl, sample),
                             build=lambda: program.build(impl), args=sample,
                             pattern=impl.describe(), impl=dict(impl),
                             sources=(search.pattern_sources(impl)
                                      if on_card else ()))

        ledger = MeasurementLedger(
            lambda impl: executor.measure_one(job(impl), warmup=cfg.warmup,
                                              reps=cfg.reps),
            budget=cfg.max_measurements,
            measure_batch_fn=lambda impls: executor.measure_batch(
                [job(i) for i in impls], warmup=cfg.warmup, reps=cfg.reps),
            prefetch_fn=lambda impls: executor.prefetch(
                [job(i) for i in impls]),
            quarantine=quarantine)
        # cross-run reuse: sibling cache entries measured under the same
        # conditions donate their per-pattern measurements
        primed: list[Measurement] = []
        if store is not None:
            for m in store.measurements_for(mkey):
                impl = Impl(m.get("impl", {}))
                pm = Measurement(
                    pattern=str(m.get("pattern", impl.describe())),
                    compile_seconds=float(m.get("compile_seconds", 0.0)),
                    run_seconds=float(m.get("run_seconds", float("inf"))),
                    runs=[], ok=bool(m.get("ok", False)),
                    error=str(m.get("error", "")), impl=dict(impl),
                    first_run_seconds=float(m.get("first_run_seconds", 0.0)))
                ledger.prime(impl, pm)
                primed.append(pm)
        # the all-ref baseline pre-exists (the paper's running CPU system);
        # primed AFTER the cache donations so this run's fresh baseline wins
        ledger.prime(Impl(), report.baseline)

        def bound_tuning(p: VariantCandidate):
            if not cfg.tune_tiles:
                return None
            space = tuning_space(p.region, p.variant)
            if space is None:
                return None
            return BoundTuningSpace(
                space, tuple(region_map[p.region].analysis_args))

        state = SearchState(
            regions=eff_regions,
            ranked=[SearchCandidate(p.region, p.variant,
                                    p.resources.resource_fraction,
                                    p.efficiency,
                                    flops=p.analysis.flops,
                                    transcendentals=p.analysis.transcendentals,
                                    boundary_bytes=p.analysis.boundary_bytes,
                                    alignment=p.analysis.alignment,
                                    tuning=bound_tuning(p))
                    for p in ranked if p.region in eff_regions],
            resource_cap=cfg.resource_cap,
            seed=cfg.seed,
            baseline=report.baseline,
            quarantine=quarantine)
        # the roofline surrogate, seeded from the Step-3 estimates, restored
        # from persisted calibration, then calibrated on what is already
        # measured: the fresh baseline (exact re-base), then the primed
        # cross-run measurements — single-gene patterns first, so their
        # deltas are pinned before combined patterns split their residuals
        model = CostModel(candidates=state.ranked,
                          baseline_seconds=report.baseline.run_seconds
                          if report.baseline.ok else 0.0)
        if store is not None:
            model.load_state(store.cost_model_for(mkey))
        if report.baseline.ok:
            model.observe(Impl(), report.baseline.run_seconds)
        for m in sorted((p for p in primed if p.ok and p.mapping()),
                        key=lambda m: (len(m.mapping()), m.pattern)):
            model.observe(Impl(m.mapping()), m.run_seconds)
        state.cost_model = model

        # |non-ref genome space| of the survivors (make_strategy("auto"))
        space = 1
        for r in eff_regions:
            space *= 1 + sum(max(c.tuning.size(), 1) if c.tuning is not None
                             else 1 for c in state.variants_of(r))
        report.search_space = max(space - 1, 0)
        strategy = make_strategy(cfg, space_size=report.search_space)
        strategy.run(state, ledger)
        executor.shutdown()     # sync final cache stats before reading them
        report.measurements = ledger.order       # budget-consuming, in order
        report.reused = [m for m in ledger.reused() if m.mapping()]
        report.quarantined = quarantine.blocked()
        report.quarantine_records = quarantine.to_records()
        report.strategy = strategy.name
        report.search_trace = state.trace
        report.skipped_combinations = state.skipped
        report.cost_model_state = model.export_state()
        bias = model.bias_notes()
        if bias:
            report.search_trace.append(
                {"stage": "cost-model pair bias", "pairs": bias})
        stats = executor.stats.as_dict()
        report.search_trace.append({"stage": "verification executor",
                                    **stats})
        report.verify_workers = cfg.verify_workers
        report.verify_wall_s = stats["verify_wall_s"]
        report.compile_wall_s = stats["compile_wall_s"]

        # ---- Step 5: select -------------------------------------------
        # over everything the strategy was served this run: fresh
        # measurements AND cross-run primed patterns it re-proposed
        base_ok = report.baseline.ok
        best = min((m for m in ledger.served if m.ok and m.mapping()),
                   key=lambda m: m.run_seconds, default=None)
        if best is not None and (not base_ok or best.run_seconds
                                 < report.baseline.run_seconds):
            report.best_pattern = best.mapping()
            report.best_seconds = best.run_seconds
            # a failed baseline gives no meaningful reference: never claim
            # a speedup (and _sound() keeps this search out of the cache)
            report.speedup = (report.baseline.run_seconds / best.run_seconds
                              if base_ok else 1.0)
        else:
            report.best_pattern = {}
            report.best_seconds = (report.baseline.run_seconds
                                   if base_ok else 0.0)
            report.speedup = 1.0
        return report

    # ------------------------------------------------------------------
    @staticmethod
    def _report_from_cache(program: OffloadableProgram, ckey: str,
                           entry: dict, backend: str) -> PlanReport:
        report = PlanReport(
            program=program.name,
            source_loop_count=program.source_loop_count,
            loop_count=int(entry.get("loop_count", 0)),
            backend=backend,
            best_pattern=dict(entry.get("best_pattern", {})),
            speedup=float(entry.get("speedup", 1.0)),
            best_seconds=float(entry.get("best_seconds", 0.0)),
            from_cache=True,
            cache_key=ckey,
            strategy=str(entry.get("strategy", "staged")),
            verify_workers=int(entry.get("verify_workers", 1)),
        )
        report.baseline = Measurement(
            "all-ref", 0.0, float(entry.get("baseline_seconds", 0.0)), [],
            impl={})
        return report

    @staticmethod
    def _cache_entry(report: PlanReport, program: OffloadableProgram,
                     backend: str) -> dict:
        # persist EVERY ok per-pattern measurement (fresh + reused): sibling
        # searches with the same measurement_key prime their ledgers from
        # these.  Failed measurements are dropped — to be retried, not
        # remembered.
        persisted = [
            {"pattern": m.pattern, "impl": m.mapping(),
             "run_seconds": m.run_seconds,
             "compile_seconds": m.compile_seconds,
             "first_run_seconds": m.first_run_seconds,
             "ok": m.ok, "error": m.error}
            for m in list(report.measurements) + list(report.reused)
            if m.ok and m.mapping()
        ]
        return {
            "measurement_key": measurement_cache_key(program, backend),
            "measurements": persisted,
            "quarantine": list(report.quarantine_records),
            # the calibrated surrogate, keyed with the measurements it was
            # learned from (PlanCache.cost_model_for)
            "cost_model": dict(report.cost_model_state),
            "program": report.program,
            "backend": backend,
            "best_pattern": dict(report.best_pattern),
            "pattern": Impl(report.best_pattern).describe(),
            "speedup": report.speedup,
            "baseline_seconds": report.baseline.run_seconds,
            "best_seconds": report.best_seconds,
            "strategy": report.strategy,
            "loop_count": report.loop_count,
            "measured_patterns": [m.pattern for m in report.measurements],
            # provenance of the verification pipeline that produced the plan
            "verify_workers": report.verify_workers,
            "verify_wall_s": report.verify_wall_s,
            "compile_wall_s": report.compile_wall_s,
        }
