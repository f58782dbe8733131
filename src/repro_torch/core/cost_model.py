"""Roofline surrogate for the Step-4 measured search — predicted fitness
(the port of the JAX package's ``core/cost_model.py``).

The paper's verification environment (Step 4) is the expensive stage: every
candidate offload pattern is compiled (~3 h per FPGA pattern) and run on the
app's sample benchmark, which is why the budget ``d`` exists and why the
companion GA proposals (arXiv 2004.08548 / 2011.12431) keep their
populations tiny.  But Step 3 has *already* lowered every (region, variant)
pair and recorded the quantities a roofline model needs — flops,
transcendental counts, boundary bytes, layout alignment, on-chip memory
fraction (shared memory per block for a hand-written kernel).
This module turns those per-gene estimates into a **predicted seconds for
any composite ``Impl`` genome**, so a search strategy can score a whole
population for free and spend real measurements only where the model says
it matters (``GeneticSearch(surrogate=True)``, strategy name
``"surrogate"``).

Model
-----
A genome's predicted time is additive over its genes around the all-ref
base::

    predict(impl) = base_seconds + sum_{(r, v) in impl, v != ref} delta[r, v]

where ``delta[r, v] = accel_time(r, v) - host_time(r)`` starts from a
two-sided roofline:

* ``accel_time`` — ``max(flops / PEAK_FLOPS, bytes / HBM_BW)`` plus a
  transcendental-unit term, divided by the Step-2 alignment score
  (misaligned loops feed the tensor cores badly, the paper's FPGA-clock
  caveat),
  plus a fixed launch overhead so near-empty regions never predict ~0.
* ``host_time``  — ``flops / HOST_FLOPS + bytes / HOST_BW`` (a sequential,
  loop-faithful host does not overlap compute with memory).

Absolute constants only seed the model; **online calibration** replaces
them: every real measurement the search makes (including cross-run ledger
hits primed from the plan cache) is fed back via :meth:`CostModel.observe`.
The update is a Kaczmarz projection on the linear gene system — the
residual is split equally across the genome's genes — so a single-gene
observation pins that gene's delta exactly, and on a consistent (additive)
workload the prediction error is non-increasing as observations accumulate.
``history`` records (pattern, predicted, measured) for every observation;
``PlanReport.search_trace`` surfaces the per-generation view.

The model is deliberately deterministic: no RNG, no clock — identical
inputs give identical predictions, so surrogate searches stay reproducible
from ``PlannerConfig.seed``.

Tile-parameter genes
--------------------
When the genome carries tile params (``(variant, params)`` genes — the
paper's loop-resizing knobs made search genes), the delta of a tuned gene
seeds from its base variant's delta plus a deterministic tile adjustment:
a grid-occupancy term (smaller blocks → more grid steps → more per-step
overhead), an unroll instruction-count term (lower unroll → more loop
control per element), and a shared-memory knee (tile footprints pushing
the region's Step-3 fraction of a block's shared memory past
``SMEM_KNEE`` pay a growing penalty: fewer blocks fit an SM).
Each tuned gene then calibrates online exactly like a bare gene, so the
surrogate prunes most of a tile grid from the seeds and pins the few
points it actually measures.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from repro_torch.core.intensity import TRANSCENDENTAL_WEIGHT
from repro_torch.core.regions import (Impl, canonical_gene, gene_variant,
                                      tuning_space)
from repro_torch.launch.constants import HBM_BW, PEAK_FLOPS_BF16, SFU_RATE

# Accelerator-side seeds: published NVIDIA H100 SXM figures at its full
# 700 W limit (the roofline terms chip_smoke.py's bounds use).  Only the
# host-vs-accelerator ratio matters before calibration replaces the scale.
ACCEL_FLOPS = PEAK_FLOPS_BF16   # dense bf16 tensor-core flop/s
ACCEL_BW = HBM_BW               # HBM3 bytes/s
ACCEL_TRANSCENDENTAL_RATE = SFU_RATE  # SFU sin/cos/exp per second

# Host-side seeds (sequential loop-faithful ref code).  Only the
# host-vs-accelerator *ratio* matters before calibration kicks in.
HOST_FLOPS = 5e9                # flop/s of a scalar-ish host loop
HOST_BW = 20e9                  # bytes/s effective host streaming
LAUNCH_OVERHEAD = 5e-6          # per-offloaded-region dispatch cost, seconds
# When a measured all-ref baseline is available, per-region host times are
# rescaled so the surviving regions account for at most this share of it.
# This pins the model to the observed time scale: raw HOST_* seeds can be
# off by orders of magnitude on unknown hardware, and un-rescaled deltas
# would drive composite predictions negative (into the clamp floor, where
# ranking degenerates to the tie-break).
HOST_SHARE = 0.9

# Residual-bias detection AND correction for gene pairs (ROADMAP "region
# interaction terms").  A multi-gene observation whose residual keeps the
# same sign BIAS_STREAK times in a row for some gene pair marks that pair
# as non-additive — a combined pattern changing fusion boundaries breaks
# the per-gene additivity the model assumes.  Residuals within
# BIAS_REL_DEADBAND of the measured time count as zero (plain timing noise
# must not accumulate into a "bias").  When a pair is flagged, the mean
# residual of the flagging streak is folded into a sticky per-pair
# correction term that ``predict`` adds whenever BOTH genes are in the
# genome — single-gene predictions are untouched, so Kaczmarz gene pins
# stay exact.  The fold is an integral controller: once the correction
# absorbs the interaction, later residuals fall inside the deadband, the
# streak breaks, and the accumulated term stops moving (no oscillation
# between "flagged" and "forgotten").
BIAS_STREAK = 3
BIAS_REL_DEADBAND = 0.01

# Tile-adjustment seeds (replaced by online calibration like every other
# delta).  GRID_STEP_OVERHEAD is the per-extra-grid-step dispatch cost a
# smaller block buys; UNROLL_OVERHEAD the fraction of a region's
# accelerator time attributed to loop control at unroll=default (scaled by
# how much less/more unrolled the point is); the shared-memory knee
# penalizes tile footprints that push a region's resource fraction past
# SMEM_KNEE of the
# budget.  In the port that fraction is Step 3's shared memory per block
# against Hopper's 232,448 bytes: past the knee fewer blocks fit an SM —
# the paper's resource-envelope constraint, soft here because kernels
# clamp instead of failing.
GRID_STEP_OVERHEAD = 2e-6
UNROLL_OVERHEAD = 0.05
SMEM_KNEE = 0.5
SMEM_PRESSURE = 0.5


def _trailing_streak(resid: list) -> int:
    """Length of the trailing same-sign run (deadband residuals break it)."""
    streak, sign = 0, 0
    for r in reversed(resid):
        s = (1 if r > BIAS_REL_DEADBAND
             else -1 if r < -BIAS_REL_DEADBAND else 0)
        if s == 0 or (sign and s != sign):
            break
        sign = s
        streak += 1
    return streak


def _impl_genes(impl) -> tuple:
    """Non-ref genes of an offload pattern, canonically ordered.  Genes are
    canonicalized (default tile params drop to the bare variant) so the
    model and the measurement ledger agree on gene identity."""
    return tuple(sorted((r, canonical_gene(r, v))
                        for r, v in dict(impl).items()
                        if gene_variant(v) != "ref"))


def _gene_base(g) -> tuple:
    """The (region, variant_name) base of a gene — tile params stripped.
    Pairwise interaction terms key on this: whether two regions fuse badly
    does not depend on which tile point either one runs."""
    r, v = g
    return (r, v) if isinstance(v, str) else (r, v[0])


def _gene_sort_key(g):
    """Total order over bare and tuned genes (str and tuple values do not
    compare directly): (region, variant, params)."""
    r, v = g
    return (r, v, ()) if isinstance(v, str) else (r, v[0], tuple(v[1]))


@dataclass
class CostModel:
    """Predicted-seconds surrogate over composite offload genomes.

    Parameters
    ----------
    candidates:
        Step-3 ``SearchCandidate``-like objects (duck-typed): each must
        carry ``region``, ``variant``, ``flops``, ``transcendentals``,
        ``boundary_bytes``, ``alignment``.  One entry per eligible
        (region, variant) pair; region-level numbers may repeat across a
        region's variants (they describe the same loop).
    baseline_seconds:
        Optional hint for the all-ref base time.  The first all-ref
        observation replaces it exactly.
    """
    candidates: list = field(default_factory=list)
    baseline_seconds: float = 0.0
    history: list = field(default_factory=list)   # [{pattern, predicted, measured}]
    _delta: dict = field(default_factory=dict)    # (region, variant) -> seconds
    _base: float = 0.0
    # (gene, gene) -> [relative residuals of the multi-gene observations
    # containing the pair, in observation order] — see bias_notes()
    _pair_resid: dict = field(default_factory=dict)
    # (gene, gene) -> [this pair's share of the absolute residual, seconds]
    # (aligned 1:1 with _pair_resid entries)
    _pair_abs: dict = field(default_factory=dict)
    # (gene, gene) -> accumulated interaction correction in seconds, added
    # by predict() when both genes are present in the genome
    _pair_corr: dict = field(default_factory=dict)

    def __post_init__(self):
        self._cand = {(c.region, c.variant): c for c in self.candidates}
        host = {}
        for c in self.candidates:
            host.setdefault(c.region, self.host_seconds(c))
        self._base = (self.baseline_seconds
                      or sum(host.values()) or 1e-3)
        # anchor the host estimates to the measured time scale: the
        # surviving regions claim at most HOST_SHARE of the baseline,
        # apportioned by their relative estimated host cost
        total = sum(host.values())
        if self.baseline_seconds > 0.0 and total > 0.0:
            gain = HOST_SHARE * self.baseline_seconds / total
            host = {r: h * gain for r, h in host.items()}
        for c in self.candidates:
            self._delta[(c.region, c.variant)] = (
                self.accel_seconds(c) - host.get(c.region, 0.0))

    # -- roofline seeds ------------------------------------------------
    @staticmethod
    def accel_seconds(c) -> float:
        """Offloaded-region roofline: min(compute, memory) performance =
        max(compute, memory) time, discounted by layout alignment."""
        compute = c.flops / ACCEL_FLOPS
        memory = c.boundary_bytes / ACCEL_BW
        trans = c.transcendentals / ACCEL_TRANSCENDENTAL_RATE
        align = max(getattr(c, "alignment", 1.0), 1e-3)
        return (max(compute, memory) + trans) / align + LAUNCH_OVERHEAD

    @staticmethod
    def host_seconds(c) -> float:
        """Loop-faithful host execution: no compute/memory overlap."""
        flops = c.flops + TRANSCENDENTAL_WEIGHT * c.transcendentals
        return flops / HOST_FLOPS + c.boundary_bytes / HOST_BW

    # -- tile-parameter terms ------------------------------------------
    def _tile_adjustment(self, region: str, variant: str, params) -> float:
        """Deterministic seconds adjustment of a tile point relative to the
        variant's defaults: grid occupancy + unroll instruction count +
        shared-memory knee.  0.0 when the variant declared no TuningSpace
        or the Step-3 candidate record is unknown."""
        c = self._cand.get((region, variant))
        space = tuning_space(region, variant)
        if c is None or space is None:
            return 0.0
        accel = self.accel_seconds(c)
        p = dict(params or {})
        adj, smem_ratio = 0.0, 1.0
        for name, default in space.default_params().items():
            val = p.get(name, default)
            if (not isinstance(val, (int, float))
                    or not isinstance(default, (int, float))
                    or val <= 0 or default <= 0):
                continue  # 0-sentinel "auto" knobs carry no seed signal
            if "unroll" in name:
                adj += UNROLL_OVERHEAD * accel * (default / val - 1.0)
            else:
                adj += GRID_STEP_OVERHEAD * (default / val - 1.0)
                smem_ratio *= val / default
        frac = getattr(c, "resource_fraction", 0.0) * smem_ratio
        if frac > SMEM_KNEE:
            adj += (SMEM_PRESSURE * accel
                    * (frac - SMEM_KNEE) / max(1.0 - SMEM_KNEE, 1e-6))
        return adj

    def _gene_delta(self, g) -> float:
        """Current delta of a gene; a tuned gene not yet observed seeds
        from its base variant's delta plus the tile adjustment (shared by
        predict AND observe, so calibration starts from the seed, not 0)."""
        d = self._delta.get(g)
        if d is not None:
            return d
        region, val = g
        if isinstance(val, str):
            return 0.0
        variant = val[0]
        return (self._delta.get((region, variant), 0.0)
                + self._tile_adjustment(region, variant, dict(val[1])))

    # -- prediction ----------------------------------------------------
    def predict(self, impl) -> float:
        """Predicted run seconds of a composite genome (never negative).

        Additive over genes, plus the learned pairwise interaction term for
        every flagged gene pair present in the genome (see ``bias_notes``);
        a genome with fewer than two non-ref genes never receives a pair
        correction, so single-gene observations stay exactly pinned."""
        t = self._base
        genes = _impl_genes(impl)
        for g in genes:
            t += self._gene_delta(g)
        if len(genes) >= 2 and self._pair_corr:
            base = [_gene_base(g) for g in genes]
            for pair in itertools.combinations(base, 2):
                t += self._pair_corr.get(pair, 0.0)
        return max(t, 1e-9)

    # -- online calibration --------------------------------------------
    def observe(self, impl, measured_seconds: float) -> None:
        """Feed one real measurement back (a ledger miss OR a cross-run
        primed hit).  Kaczmarz step: the residual against the current
        prediction is split equally over the genome's non-ref genes; an
        all-ref observation re-bases the model exactly."""
        if not (measured_seconds == measured_seconds      # NaN
                and measured_seconds != float("inf")):
            return
        predicted = self.predict(impl)
        genes = _impl_genes(impl)
        self.history.append({
            "pattern": Impl(dict(impl)).describe(),
            "predicted": predicted,
            "measured": measured_seconds,
        })
        err = measured_seconds - predicted
        if not genes:
            self._base = measured_seconds
            return
        if len(genes) >= 2:
            # record the pre-update relative residual against every gene
            # pair in the genome: the Kaczmarz step below absorbs the error,
            # so a pair whose residual keeps coming back with the same sign
            # is systematically non-additive (see bias_notes)
            rel = err / max(abs(measured_seconds), 1e-12)
            # pair keys strip tile params: the interaction is between the
            # regions' variants, not any particular tile point, and the
            # persisted pair_corr format stays exactly as before tuning
            pairs = list(itertools.combinations(
                [_gene_base(g) for g in genes], 2))
            for pair in pairs:
                self._pair_resid.setdefault(pair, []).append(rel)
                self._pair_abs.setdefault(pair, []).append(err / len(pairs))
                streak = _trailing_streak(self._pair_resid[pair])
                if streak >= BIAS_STREAK:
                    # flagged: fold the streak's mean absolute residual into
                    # the sticky pair correction.  Later single-gene pins
                    # can't undo this (predict only applies it pairwise),
                    # and once it converges the residuals drop into the
                    # deadband and the streak stops extending.
                    tail = self._pair_abs[pair][-streak:]
                    self._pair_corr[pair] = (self._pair_corr.get(pair, 0.0)
                                             + sum(tail) / len(tail))
        for g in genes:
            self._delta[g] = self._gene_delta(g) + err / len(genes)

    def bias_notes(self) -> list[dict]:
        """Gene pairs whose multi-gene observations stay systematically
        biased: the trailing run of same-sign relative residuals (deadband
        ``BIAS_REL_DEADBAND``) reached ``BIAS_STREAK``.  ``sign`` reads from
        the model's point of view — ``"under-predicted"`` means combined
        patterns keep measuring *slower* than the additive prediction
        (positive interaction, e.g. a broken fusion boundary).  Surfaced on
        ``PlanReport.search_trace`` by the planner so the surrogate's trust
        in composite predictions is visible."""
        notes = []
        for pair, resid in sorted(self._pair_resid.items()):
            streak = _trailing_streak(resid)
            corr = self._pair_corr.get(pair, 0.0)
            # a pair stays on the report while its correction is applied,
            # even after the (now-corrected) residuals fall into the
            # deadband and the live streak dies down
            if streak < BIAS_STREAK and corr == 0.0:
                continue
            tail = resid[-streak:] if streak else []
            sign = tail[-1] if tail else corr
            notes.append({
                "pair": [list(g) for g in pair],
                "sign": "under-predicted" if sign > 0 else "over-predicted",
                "observations": streak,
                "mean_rel_residual": (sum(tail) / len(tail)) if tail else 0.0,
                # the sticky interaction term predict() applies when both
                # genes co-occur (0.0 until the first fold)
                "corrected_seconds": corr,
            })
        return notes

    # -- persistence ---------------------------------------------------
    def export_state(self) -> dict:
        """JSON-safe snapshot of everything calibration has learned: the
        re-based all-ref time, per-gene deltas, and the sticky pairwise
        interaction corrections.  Stored next to the measurements in the
        plan cache so a re-opened search starts calibrated instead of from
        the roofline seeds.

        Bare genes keep the pre-tuning 3-element ``[region, variant,
        seconds]`` row format (old snapshots round-trip bit-identically);
        a tuned gene exports a 4-element ``[region, variant, [[name,
        value], ...], seconds]`` row that old readers simply skip."""
        delta = []
        for (r, v), s in sorted(self._delta.items(),
                                key=lambda kv: _gene_sort_key(kv[0])):
            if isinstance(v, str):
                delta.append([r, v, s])
            else:
                delta.append([r, v[0], [[k, val] for k, val in v[1]], s])
        return {
            "base": self._base,
            "delta": delta,
            "pair_corr": [[list(a), list(b), s]
                          for (a, b), s in sorted(self._pair_corr.items())],
        }

    def load_state(self, state) -> bool:
        """Merge a persisted :meth:`export_state` snapshot (tolerant of
        malformed entries — a corrupt cache degrades to the seeds, never
        raises).  Returns True if anything was restored."""
        if not isinstance(state, dict) or not state:
            return False
        loaded = False
        base = state.get("base")
        if isinstance(base, (int, float)) and base > 0.0:
            self._base = float(base)
            loaded = True
        for item in state.get("delta", ()):
            try:
                if len(item) == 4:            # tuned gene: tile-param row
                    r, v, params, s = item
                    key = (str(r), (str(v), tuple((str(k), val)
                                                  for k, val in params)))
                else:
                    r, v, s = item
                    key = (str(r), str(v))
                self._delta[key] = float(s)
                loaded = True
            except (TypeError, ValueError):
                continue
        for item in state.get("pair_corr", ()):
            try:
                a, b, s = item
                pair = (tuple(map(str, a)), tuple(map(str, b)))
                if len(pair[0]) == 2 and len(pair[1]) == 2:
                    self._pair_corr[pair] = float(s)
                    loaded = True
            except (TypeError, ValueError):
                continue
        return loaded

    # -- diagnostics ---------------------------------------------------
    def mean_abs_rel_error(self, last: int | None = None) -> float:
        """Mean |predicted - measured| / measured over the observation
        history (optionally only the last ``last`` entries)."""
        hist = self.history[-last:] if last else self.history
        if not hist:
            return 0.0
        return sum(abs(h["predicted"] - h["measured"]) / max(h["measured"], 1e-12)
                   for h in hist) / len(hist)
