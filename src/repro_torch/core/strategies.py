"""Pluggable Step-4 search strategies over the offload-pattern space.

The source paper narrows loop candidates (AI filter -> resource filter)
because each FPGA pattern costs hours to compile, then spends a fixed budget
``d`` measuring patterns.  This module makes that search a pluggable layer:

* ``StagedSearch``     — the paper's 3-round heuristic (round 1: best
  destination per surviving region, singly; round 2: cross-region
  combinations of round-1 winners under the resource cap; round 3: leftover
  budget on runner-up destinations), plus round 4's tile hill climb when the
  planner attaches tuning spaces.
* ``GeneticSearch``    — a population of ``Impl`` genomes, one gene per
  surviving region over ``{ref} ∪ eligible variants``, seeded from the
  Step-3 efficiency ranking; tournament selection + uniform crossover +
  per-gene mutation, over-cap genomes repaired toward ``ref``.  Its draws
  come from ``random.Random(SearchState.seed)`` in the JAX package's order,
  so the same seed and the same measurements give the same proposals.
* ``ExhaustiveSearch`` — the full genome space in deterministic order; the
  parity oracle for tiny spaces.
* ``"surrogate"``       — ``GeneticSearch(surrogate=True)``: the population
  is scored by the roofline ``CostModel`` (core/cost_model.py) and real
  measurements go only to each generation's predicted top-k (at most
  ``d - 1`` in total); every real measurement recalibrates the model.
* ``"auto"``            — ``make_strategy`` picks from the space size.

The interface is ask–tell, expressed as a Python generator: a strategy's
``proposals(state, ledger)`` *asks* by yielding an ``Impl`` and is *told*
the resulting ``Measurement`` as the value of the ``yield`` expression.
``SearchStrategy.run`` drives the generator through a ``MeasurementLedger``,
so a genome re-proposed within one run is served from the ledger and only
ledger misses consume budget.  The strategy never sees the program or the
clock — everything it may exploit is in the shared ``SearchState``.

A strategy may also yield a *batch* — a ``list`` of Impls — and is told a
list of ``Optional[Measurement]`` in the same order (``None`` marks the
unaffordable tail once the budget runs out mid-batch): batches let the
verification executor (core/executor.py) run a round's compile steps
concurrently while the timed reps stay serial.  ``ledger.prefetch(impls)``
is the free compile-ahead hint.  The proposal sequences are those of the
JAX package's strategies, pattern for pattern.
"""
from __future__ import annotations

import itertools
import random
from dataclasses import dataclass, field

from repro_torch.core.regions import Impl, gene_variant, split_gene
from repro_torch.core.search import Measurement, MeasurementLedger

STRATEGY_NAMES = ("staged", "genetic", "surrogate", "exhaustive", "auto")

# make_strategy("auto") thresholds, as in the JAX package: the whole space is
# affordable -> exhaustive; a small space is covered well by the paper's
# 3-round heuristic -> staged; otherwise the surrogate GA.
AUTO_STAGED_MAX_SPACE = 16


@dataclass(frozen=True)
class SearchCandidate:
    """One eligible (region, variant) destination with its Step-3 numbers.

    ``resource_fraction``/``efficiency`` drive ranking and cap accounting;
    the raw analysis counts (``flops``, ``transcendentals``,
    ``boundary_bytes``, ``alignment``) seed the roofline ``CostModel`` of
    the surrogate search.  They default to 0/1 so hand-built states that
    only rank still work.

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
    flops: float = 0.0              # raw region flops (not penalty-weighted)
    transcendentals: float = 0.0
    boundary_bytes: float = 0.0
    alignment: float = 1.0
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
    seed: int = 0
    baseline: Measurement | None = None
    skipped: list[str] = field(default_factory=list)
    trace: list[dict] = field(default_factory=list)
    # roofline surrogate (core/cost_model.py), attached by the planner;
    # duck-typed: predict/observe/history.  None -> surrogate-mode
    # strategies degrade to their measured behavior.
    cost_model: object | None = None
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


def _step_gene(value, space, rng) -> object:
    """Neighbor-step tile mutation: move the gene's params one position
    along one axis of its TuningSpace (valid points only); a bare variant
    steps off its defaults.  Canonicalized, so stepping back onto the
    defaults returns the bare variant gene."""
    name, params = split_gene(value)
    nbrs = space.neighbors(params)
    if not nbrs:
        return value
    canon = space.canonical(nbrs[rng.randrange(len(nbrs))])
    return name if not canon else (name, canon)


class SearchStrategy:
    """Ask–tell search driver.  Subclasses implement ``proposals``."""
    name = "base"

    def proposals(self, state: SearchState, ledger: MeasurementLedger):
        """Generator protocol: ``yield impl`` asks for a measurement; the
        ``yield`` expression evaluates to the Measurement (tell).  ``yield
        [impl, ...]`` asks for a *batch* and evaluates to a same-order list
        of ``Optional[Measurement]`` (``None`` once the budget ran out
        mid-batch).  Strategies may read ``ledger.budget``/``ledger.seen``
        and hint ``ledger.prefetch`` but never measure directly."""
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
class GeneticSearch(SearchStrategy):
    """GA over mixed {region -> destination} genomes (arXiv 2004.08548 /
    2011.12431).  One gene per surviving region; allele space
    ``{ref} ∪ eligible variants``.  Deterministic from ``state.seed``.

    With ``surrogate=True`` (strategy name ``"surrogate"``) the whole
    population is scored with the roofline ``CostModel`` on
    ``state.cost_model`` and real measurements are spent only on each
    generation's predicted top-``topk``:

    * generation 0 measures its top-k unconditionally (calibration
      bootstrap — the model starts from uncalibrated roofline seeds);
    * later generations measure an unseen genome only when the model
      predicts it beats the best measurement so far (a genome the model
      calls slower is scored by prediction alone);
    * total real measurements are capped at ``d - 1`` (floor 1) — the
      surrogate never exhausts the verification budget, so at any
      ``d >= 2`` it consumes strictly fewer real measurements than the
      plain GA whenever the plain GA would spend all of ``d``, while the
      model scores the (much larger) rest of the population for free;
    * every real measurement (ledger misses AND free cross-run hits) is
      fed back through ``CostModel.observe`` to recalibrate the model.

    Selection still only ever picks a *measured* pattern — predicted
    fitness steers evolution, never the final answer.  Without a cost
    model on the state, surrogate mode degrades to plain measured GA.

    Verification pipelining: the plain GA proposes each generation as one
    *batch* (arXiv 2004.08548 verifies a whole population in parallel on
    the verification environment), so all fresh genomes' compile steps run
    concurrently before the strictly-serial timing pass.  Surrogate mode
    proposes serially (each measurement feeds the model that decides the
    next) but hints ``ledger.prefetch`` with the predicted top-``2*topk``
    each generation — the speculative compile-ahead usually has the next
    proposal's executable warm by the time it is asked for.
    """
    name = "genetic"

    def __init__(self, population: int = 6, generations: int = 4,
                 crossover: float = 0.9, mutation: float = 0.15,
                 tournament: int = 2, elite: int = 1,
                 topk: int = 2, surrogate: bool = False):
        self.population = max(population, 2)
        self.generations = max(generations, 1)
        self.crossover = crossover
        self.mutation = mutation
        self.tournament = max(tournament, 1)
        self.elite = max(elite, 0)
        self.topk = max(topk, 1)
        self.surrogate = surrogate
        if surrogate:
            self.name = "surrogate"

    def proposals(self, state: SearchState, ledger: MeasurementLedger):
        regions = list(state.regions)
        if not regions:
            return
        rng = random.Random(state.seed)
        # alleles include every valid non-default tile point of variants
        # that declared a TuningSpace — identical to the pre-tuning list
        # when none did, so golden GA trajectories are unchanged
        alleles = {r: _tile_alleles(state, r) for r in regions}
        tuned_spaces = {r: {c.variant: c.tuning for c in state.variants_of(r)
                            if c.tuning is not None}
                        for r in regions}
        has_tuning = any(tuned_spaces[r] for r in regions)
        frac = state.fractions()
        model = state.cost_model if self.surrogate else None
        # surrogate self-cap: never spend the full verification budget —
        # at most d-1 real measurements in total (floor 1), so at any
        # d >= 2 the surrogate consumes strictly fewer measurements than
        # the plain GA whenever the plain GA would exhaust the budget
        real_cap = (max(1, ledger.budget - 1)
                    if model is not None else float("inf"))
        real_spent = 0
        best_measured = (state.baseline.run_seconds
                         if state.baseline is not None and state.baseline.ok
                         else float("inf"))

        def repair(g: dict) -> dict:
            # over-cap genomes repaired toward ref: the heaviest gene is
            # switched off until the genome fits (paper: combinations over
            # the FPGA resource limit are never built).  Quarantined genes
            # (possible via neighbor-step tile mutation, whose moves don't
            # come from the filtered allele lists) repair to ref too.
            g = dict(g)
            for r in regions:
                if not state.gene_allowed(r, g[r]):
                    g[r] = "ref"
            while state.impl_fraction(g) > state.resource_cap:
                on = [r for r in regions if gene_variant(g[r]) != "ref"]
                if not on:
                    break
                g[max(on, key=lambda r: frac.get(
                    (r, gene_variant(g[r])), 0.0))] = "ref"
            return g

        def to_impl(g: dict) -> Impl:
            return Impl({r: v for r, v in g.items()
                         if gene_variant(v) != "ref"})

        # seed population from the Step-3 efficiency ranking: the all-best
        # genome first (the staged round-2 full combination), then the
        # ranked singles (staged round 1/3), then random genomes
        pop: list[dict] = [{r: (alleles[r][1] if len(alleles[r]) > 1
                                else "ref") for r in regions}]
        for c in state.ranked:
            if len(pop) >= self.population:
                break
            g = {r: "ref" for r in regions}
            g[c.region] = c.variant
            pop.append(g)
        while len(pop) < self.population:
            pop.append({r: rng.choice(alleles[r]) for r in regions})
        pop = [repair(g) for g in pop[:self.population]]

        for generation in range(self.generations):
            t = state.begin_stage(f"generation {generation}")
            t["genomes"] = []
            scored: list[tuple[float, dict]] = []
            impls = [to_impl(g) for g in pop]
            obs_before = len(model.history) if model is not None else 0
            topset: set[int] = set()
            died = False
            if model is not None:
                # predicted fitness for the WHOLE population, ties broken by
                # pattern string so the trajectory stays deterministic
                order = sorted(range(len(pop)),
                               key=lambda i: (model.predict(impls[i]),
                                              impls[i].describe()))
                topset = set(order[:self.topk])
                # speculative compile-ahead: the predicted top-2k are the
                # genomes most likely to be proposed (this generation's
                # top-k now; elites and near-winners next generation) —
                # warm their compiles while earlier proposals are timed
                ledger.prefetch([impls[i] for i in order[:2 * self.topk]])
            if model is None:
                # plain measured GA: the whole generation is ONE batch —
                # all fresh genomes compile concurrently, ledger hits
                # (elites, duplicate offspring) are served free, and the
                # timed measurements keep population order
                results = yield impls
                for g, impl, m in zip(pop, impls, results):
                    predicted = (state.cost_model.predict(impl)
                                 if state.cost_model is not None else None)
                    entry = {"pattern": impl.describe(),
                             "predicted": predicted,
                             "measured": None, "source": "measured"}
                    if m is None:        # budget died mid-generation
                        died = True
                        continue
                    t["patterns"].append(impl.describe())
                    entry["measured"] = m.run_seconds if m.ok else None
                    t["genomes"].append(entry)
                    scored.append((m.run_seconds if m.ok else float("inf"), g))
            else:
                for i, g in enumerate(pop):
                    impl = impls[i]
                    predicted = (state.cost_model.predict(impl)
                                 if state.cost_model is not None else None)
                    entry = {"pattern": impl.describe(),
                             "predicted": predicted,
                             "measured": None, "source": "model"}
                    # surrogate: spend real measurements only where it matters
                    free = ledger.seen(impl)
                    worthwhile = (generation == 0 or free
                                  or predicted < best_measured)
                    affordable = free or (real_spent < real_cap
                                          and not ledger.exhausted())
                    if (free or i in topset) and worthwhile and affordable:
                        if not free:
                            real_spent += 1
                        m = yield impl
                        t["patterns"].append(impl.describe())
                        if m.ok:
                            model.observe(impl, m.run_seconds)
                            best_measured = min(best_measured, m.run_seconds)
                            entry["measured"] = m.run_seconds
                        entry["source"] = "ledger" if free else "measured"
                        t["genomes"].append(entry)
                        scored.append(
                            (m.run_seconds if m.ok else float("inf"), g))
                    else:
                        t["genomes"].append(entry)
                        scored.append((predicted, g))
            t["budget_left"] = ledger.budget
            if model is not None:
                t["real_measurements"] = real_spent
                n_obs = len(model.history) - obs_before
                t["model_error"] = (model.mean_abs_rel_error(last=n_obs)
                                    if n_obs else None)
            if died or generation + 1 >= self.generations \
                    or ledger.exhausted():
                return
            if model is not None and real_spent >= real_cap:
                # the measurement allowance is gone: further generations can
                # only re-score, never change the (measured-only) selection
                return
            scored.sort(key=lambda t: t[0])

            def tournament_pick() -> dict:
                picks = [scored[rng.randrange(len(scored))]
                         for _ in range(self.tournament)]
                return min(picks, key=lambda t: t[0])[1]

            nxt = [dict(g) for _, g in scored[:self.elite]]   # elites: ledger
            while len(nxt) < self.population:                 # hits, free
                p1, p2 = tournament_pick(), tournament_pick()
                if rng.random() < self.crossover:             # uniform
                    child = {r: (p1[r] if rng.random() < 0.5 else p2[r])
                             for r in regions}
                else:
                    child = dict(p1)
                for r in regions:                             # per-gene
                    if rng.random() < self.mutation:
                        child[r] = rng.choice(alleles[r])
                if has_tuning:
                    # neighbor-step tile mutation: nudge one axis of a
                    # tunable gene one position.  RNG is consumed only
                    # when tuning spaces exist, so pre-tuning runs keep
                    # their exact draw sequence.
                    for r in regions:
                        space = tuned_spaces[r].get(gene_variant(child[r]))
                        if space is not None \
                                and rng.random() < self.mutation:
                            child[r] = _step_gene(child[r], space, rng)
                nxt.append(repair(child))
            pop = nxt


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
    """Strategy instance from a PlannerConfig (its ``strategy`` + GA knobs).

    ``strategy="auto"`` picks for the caller from the size of the genome
    space (the planner passes ``space_size`` = |non-ref patterns| of the
    Step-3 survivors; the JAX package's thresholds):

    * ``space_size <= max_measurements``  -> ``exhaustive`` (the whole
      space is affordable: measuring everything IS the optimum),
    * ``space_size <= AUTO_STAGED_MAX_SPACE`` -> ``staged`` (the paper's
      3-round heuristic covers a small space well),
    * otherwise -> the surrogate GA (predicted fitness stretches ``d``
      over a population the measured strategies could never afford).

    With no ``space_size`` (ad-hoc callers), ``auto`` falls back to
    ``staged`` — the paper's default.
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
    if name in ("genetic", "surrogate"):
        return GeneticSearch(population=config.ga_population,
                             generations=config.ga_generations,
                             crossover=config.ga_crossover,
                             mutation=config.ga_mutation,
                             tournament=config.ga_tournament,
                             elite=config.ga_elite,
                             topk=getattr(config, "ga_topk", 2),
                             surrogate=(name == "surrogate"))
    if name == "exhaustive":
        return ExhaustiveSearch()
    raise ValueError(f"unknown search strategy {name!r}; "
                     f"choose from {STRATEGY_NAMES}")
