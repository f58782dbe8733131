"""Pluggable Step-4 search strategies over the offload-pattern space.

The source paper narrows loop candidates (AI filter -> resource filter)
because each FPGA pattern costs hours to compile, then spends a fixed budget
``d`` measuring patterns.  This module makes that search a pluggable layer:

* ``StagedSearch``     — the paper's 3-round heuristic (round 1: best
  destination per surviving region, singly; round 2: cross-region
  combinations of round-1 winners under the resource cap; round 3: leftover
  budget on runner-up destinations), plus round 4's tile hill climb when the
  planner attaches tuning spaces.
* ``ExhaustiveSearch`` — the full genome space in deterministic order; the
  parity oracle for tiny spaces.

The genetic and surrogate strategies of the JAX package (and ``"auto"``
when it would pick the surrogate) wait for slice 3 of the port, with the
cost model they rely on; :func:`make_strategy` raises
``NotImplementedError`` for them.

The interface is ask–tell, expressed as a Python generator: a strategy's
``proposals(state, ledger)`` *asks* by yielding an ``Impl`` and is *told*
the resulting ``Measurement`` as the value of the ``yield`` expression.
``SearchStrategy.run`` drives the generator through a ``MeasurementLedger``,
so a genome re-proposed within one run is served from the ledger and only
ledger misses consume budget.  The strategy never sees the program or the
clock — everything it may exploit is in the shared ``SearchState``.

A strategy may also yield a *batch* — a ``list`` of Impls — and is told a
list of ``Optional[Measurement]`` in the same order (``None`` marks the
unaffordable tail once the budget runs out mid-batch).  The proposal
sequences are those of the JAX package's strategies, pattern for pattern.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from repro_torch.core.regions import Impl, gene_variant, split_gene
from repro_torch.core.search import Measurement, MeasurementLedger

STRATEGY_NAMES = ("staged", "genetic", "surrogate", "exhaustive", "auto")

# make_strategy("auto") thresholds, as in the JAX package: the whole space is
# affordable -> exhaustive; a small space is covered well by the paper's
# 3-round heuristic -> staged; otherwise the surrogate GA (not ported yet).
AUTO_STAGED_MAX_SPACE = 16


@dataclass(frozen=True)
class SearchCandidate:
    """One eligible (region, variant) destination with its Step-3 numbers.

    ``resource_fraction``/``efficiency`` drive ranking and cap accounting.

    ``tuning`` is the variant's tile-parameter space when the planner runs
    with ``tune_tiles`` (a ``BoundTuningSpace`` closed over the region's
    abstract args, duck-typed: points/neighbors/canonical).  ``None`` —
    the default, and always the case pre-tuning — keeps every strategy's
    trajectory bit-identical to the variant-only genome.
    """
    region: str
    variant: str
    resource_fraction: float
    efficiency: float
    tuning: object = None


@dataclass
class SearchState:
    """Everything a strategy may consult, shared across all strategies.

    ``regions`` are the Step-3 survivors in efficiency order; ``ranked`` the
    eligible (region, variant) pairs in rank order (regions restricted to
    the survivors).  The measurement budget lives ONLY on the ledger
    (``ledger.budget`` is the live remaining count).  ``skipped`` and
    ``trace`` are written by the strategy and surfaced on the PlanReport.
    """
    regions: list[str]
    ranked: list[SearchCandidate]
    resource_cap: float = 1.0
    baseline: Measurement | None = None
    skipped: list[str] = field(default_factory=list)
    trace: list[dict] = field(default_factory=list)
    # gene strike list (core/search.py Quarantine), attached by the planner;
    # duck-typed (is_quarantined).  None — the default for hand-built
    # states — allows every gene.
    quarantine: object | None = None

    def variants_of(self, region: str) -> list[SearchCandidate]:
        """The region's eligible destinations, best-ranked first."""
        return [c for c in self.ranked if c.region == region]

    def gene_allowed(self, region: str, gene) -> bool:
        """Whether strategies may propose this gene (``ref`` always is;
        quarantined genes — repeat permanent failers — never are)."""
        if gene_variant(gene) == "ref":
            return True
        q = self.quarantine
        return q is None or not q.is_quarantined(region, gene)

    def fractions(self) -> dict[tuple[str, str], float]:
        return {(c.region, c.variant): c.resource_fraction
                for c in self.ranked}

    def impl_fraction(self, impl) -> float:
        """Summed resource fraction of a genome's non-ref genes — the single
        definition of cap accounting all strategies share."""
        frac = self.fractions()
        return sum(frac.get((r, gene_variant(v)), 0.0)
                   for r, v in dict(impl).items()
                   if gene_variant(v) != "ref")

    def begin_stage(self, stage: str) -> dict:
        """Open a trace entry; callers fill ``patterns`` per measurement so
        a budget exhaustion mid-stage still leaves an accurate trace."""
        entry = {"stage": stage, "patterns": []}
        self.trace.append(entry)
        return entry


def _tile_alleles(state: SearchState, region: str) -> list:
    """Allele list of one region's gene: ``ref``, each eligible variant,
    and — when a variant declared a TuningSpace — every valid non-default
    tile point as a ``(variant, params)`` gene.  Quarantined genes (variants or
    individual tile points with repeated permanent failures) are filtered
    out — strategies must never propose them."""
    vals: list = ["ref"]
    for c in state.variants_of(region):
        if state.gene_allowed(region, c.variant):
            vals.append(c.variant)
        if c.tuning is not None:
            for p in c.tuning.points():
                canon = c.tuning.canonical(p)
                if canon and state.gene_allowed(region, (c.variant, canon)):
                    vals.append((c.variant, canon))
    return vals


class SearchStrategy:
    """Ask–tell search driver.  Subclasses implement ``proposals``."""
    name = "base"

    def proposals(self, state: SearchState, ledger: MeasurementLedger):
        """Generator protocol: ``yield impl`` asks for a measurement; the
        ``yield`` expression evaluates to the Measurement (tell).  ``yield
        [impl, ...]`` asks for a *batch* and evaluates to a same-order list
        of ``Optional[Measurement]`` (``None`` once the budget ran out
        mid-batch).  Strategies may read ``ledger.budget``
        but never measure directly."""
        raise NotImplementedError

    def run(self, state: SearchState, ledger: MeasurementLedger) -> None:
        gen = self.proposals(state, ledger)
        try:
            proposal = next(gen)
            while True:
                if isinstance(proposal, (list, tuple)):
                    # batched ask: hits free, misses measured in order, None
                    # marks the unaffordable tail — the strategy decides how
                    # to stop
                    results = (ledger.measure_batch(list(proposal))
                               if proposal else [])
                    proposal = gen.send(results)
                    continue
                m = ledger.measure(proposal)
                if m is None:            # budget exhausted mid-proposal
                    gen.close()
                    return
                proposal = gen.send(m)
        except StopIteration:
            return


# ---------------------------------------------------------------------------
class StagedSearch(SearchStrategy):
    """The paper's 3-round heuristic.

    Each round is one *batch* proposal: all of a round's patterns are
    handed to the ledger together and measured in order.  A ``None``
    mid-batch means the budget died inside the round, so the strategy stops
    without opening the later rounds.

    When the planner attaches TuningSpaces (``tune_tiles``), a round 4
    hill-climbs the tile params of the best pattern measured so far:
    each step proposes every valid one-axis neighbor of the current
    winner's tunable genes as one batch and moves to the best improving
    point, stopping when no neighbor improves or the budget dies.  The
    round (and its trace stage) only opens when tunable candidates exist,
    so pre-tuning runs keep the exact 3-round trace."""
    name = "staged"

    def proposals(self, state: SearchState, ledger: MeasurementLedger):
        base = state.baseline
        base_ok = base is not None and base.ok
        # running best over everything measured this run, seeded by the
        # all-ref baseline — round 4 climbs from here
        best_impl = Impl()
        best_s = base.run_seconds if base_ok else float("inf")

        def track(impl: Impl, m: Measurement) -> None:
            nonlocal best_impl, best_s
            if m.ok and m.run_seconds < best_s:
                best_impl, best_s = impl, m.run_seconds

        # trace entries are appended up-front and filled per measurement, so
        # a budget exhaustion mid-round still leaves an accurate trace
        # round 1: each surviving region's best destination, singly
        t1 = state.begin_stage("round 1 (best destination per region)")
        picks = [(region, state.variants_of(region)[0].variant)
                 for region in state.regions]
        results = yield [Impl({r: v}) for r, v in picks]
        round1: list[tuple[str, str, Measurement]] = []
        died = False
        for (region, variant), m in zip(picks, results):
            if m is None:
                died = True
                continue
            t1["patterns"].append(Impl({region: variant}).describe())
            round1.append((region, variant, m))
            track(Impl({region: variant}), m)

        # A failed baseline measures as inf, which would promote EVERY ok
        # round-1 measurement to "winner" — combinations must only be built
        # against a meaningful reference.
        winners = [(r, v) for r, v, m in round1
                   if m.ok and base_ok and m.run_seconds < base.run_seconds]
        if died:
            return

        # round 2: mixed cross-region combinations of round-1 winners
        # (largest combo first), resource-capped on the chosen variants
        t2 = state.begin_stage("round 2 (winner combinations)")
        combos: list[Impl] = []
        if not ledger.exhausted():
            for size in range(len(winners), 1, -1):
                for combo in itertools.combinations(winners, size):
                    impl = Impl(dict(combo))
                    if state.impl_fraction(impl) > state.resource_cap:
                        state.skipped.append(
                            "+".join(f"{r}={v}" for r, v in combo))
                        continue
                    combos.append(impl)
        if combos:
            results = yield combos
            for impl, m in zip(combos, results):
                if m is None:
                    died = True
                    continue
                t2["patterns"].append(impl.describe())
                track(impl, m)
        if died:
            return

        # round 3: leftover budget tries runner-up destinations singly
        t3 = state.begin_stage("round 3 (runner-up destinations)")
        tried = {(r, v) for r, v, _ in round1}
        singles: list[Impl] = []
        if not ledger.exhausted():
            for c in state.ranked:
                if (c.region not in state.regions
                        or (c.region, c.variant) in tried):
                    continue
                tried.add((c.region, c.variant))
                singles.append(Impl({c.region: c.variant}))
        if singles:
            results = yield singles
            for impl, m in zip(singles, results):
                if m is None:
                    died = True
                    continue
                t3["patterns"].append(impl.describe())
                track(impl, m)

        # round 4: tile tuning of the winning pattern (only opened when
        # Step-3 attached TuningSpaces — pre-tuning traces stay 3 rounds)
        tuned = {(c.region, c.variant): c.tuning
                 for c in state.ranked if c.tuning is not None}
        if died or not tuned or ledger.exhausted():
            return
        current, current_s = best_impl, best_s
        t4 = None
        for _ in range(4):                        # bounded hill climb
            if ledger.exhausted():
                return
            props: list[Impl] = []
            proposed: set[str] = set()
            for r in current:
                name, params = split_gene(current[r])
                space = tuned.get((r, name))
                if space is None:
                    continue
                for p in space.neighbors(params):
                    canon = space.canonical(p)
                    g = dict(current)
                    g[r] = name if not canon else (name, canon)
                    if not state.gene_allowed(r, g[r]):
                        continue          # quarantined tile point
                    impl = Impl(g)
                    key = impl.describe()
                    if key in proposed:
                        continue
                    proposed.add(key)
                    if state.impl_fraction(impl) > state.resource_cap:
                        state.skipped.append(key)
                        continue
                    props.append(impl)
            if not props:
                return
            if t4 is None:
                t4 = state.begin_stage("round 4 (tile tuning)")
            results = yield props
            improved = False
            for impl, m in zip(props, results):
                if m is None:
                    return
                t4["patterns"].append(impl.describe())
                if m.ok and m.run_seconds < current_s:
                    current, current_s = impl, m.run_seconds
                    improved = True
            if not improved:
                return


# ---------------------------------------------------------------------------
class ExhaustiveSearch(SearchStrategy):
    """Every genome in the space, deterministic order — the parity oracle
    for tiny spaces (and the paper's 'measure everything' degenerate case
    when ``d`` covers the whole space).  Proposals go out in budget-sized
    *batches*; enumeration (and skip logging) stops at the unaffordable
    tail."""
    name = "exhaustive"

    def proposals(self, state: SearchState, ledger: MeasurementLedger):
        regions = list(state.regions)
        if not regions:
            return
        # tile points of tuning-declaring variants are part of the space
        allele_lists = [_tile_alleles(state, r) for r in regions]
        t = state.begin_stage("exhaustive enumeration")

        pending: list[Impl] = []

        def flush(pending):
            results = yield pending
            for impl, m in zip(pending, results):
                if m is None:
                    return True           # budget died mid-chunk
                t["patterns"].append(impl.describe())
            return False

        for combo in itertools.product(*allele_lists):
            if ledger.exhausted() and not pending:
                return       # don't walk (or log skips for) the unaffordable tail
            impl = Impl({r: v for r, v in zip(regions, combo)
                         if gene_variant(v) != "ref"})
            if not impl:
                continue                  # all-ref = the baseline, free
            if state.impl_fraction(impl) > state.resource_cap:
                state.skipped.append(impl.describe())
                continue
            pending.append(impl)
            if len(pending) >= max(ledger.budget, 1):
                died = yield from flush(pending)
                if died:
                    return
                pending = []
        if pending:
            yield from flush(pending)


# ---------------------------------------------------------------------------
def make_strategy(config, space_size: int | None = None) -> SearchStrategy:
    """Strategy instance from a PlannerConfig's ``strategy``.

    ``strategy="auto"`` picks from the size of the genome space as the JAX
    package does: ``space_size <= max_measurements`` -> ``exhaustive``,
    ``<= AUTO_STAGED_MAX_SPACE`` -> ``staged``, otherwise the surrogate GA;
    with no ``space_size``, ``staged``.  The genetic and surrogate
    strategies raise ``NotImplementedError`` until slice 3 of the port.
    """
    name = getattr(config, "strategy", "staged")
    if name == "auto":
        if space_size is None:
            name = "staged"
        elif space_size <= getattr(config, "max_measurements", 4):
            name = "exhaustive"
        elif space_size <= AUTO_STAGED_MAX_SPACE:
            name = "staged"
        else:
            name = "surrogate"
    if name == "staged":
        return StagedSearch()
    if name == "exhaustive":
        return ExhaustiveSearch()
    if name in ("genetic", "surrogate"):
        raise NotImplementedError(
            f"search strategy {name!r} is not ported yet: it comes with "
            "slice 3 of the PyTorch port (genetic/surrogate search and the "
            "cost model); use 'staged' or 'exhaustive'")
    raise ValueError(f"unknown search strategy {name!r}; "
                     f"choose from {STRATEGY_NAMES}")
