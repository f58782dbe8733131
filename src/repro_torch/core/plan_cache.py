"""Persistent plan cache — "once written code, automatically configured per
placed hardware" (paper §1), closed in code.

The paper's pipeline is expensive by construction: Step 4 compiles each
candidate pattern for the FPGA (~3 h each).  Its answer is that the search
runs *once per (application, hardware)* and the chosen pattern is then
reused.  This module is that reuse: a JSON file mapping

    key = sha256(program name + per-region abstract arg shapes/dtypes +
                 registered variant sets + backend + planner config)

to the selected offload pattern.  ``AutoOffloader.plan(..., cache=...)``
returns a cached plan with ZERO new measurements when the key matches, and
re-plans (then stores) when anything that could change the answer changes —
the program's shapes, the variant registry, the backend the measurements
would run on, the planner budgets, or the Step-4 search strategy.

The backend comes from the program's torch device: ``"cpu"``, or
``"cuda:"`` plus the card's name (:func:`repro_torch.core.device
.backend_name`).  The default file is the port's own,
``.repro_torch_plan_cache.json`` (or ``$REPRO_TORCH_PLAN_CACHE``): JAX and
PyTorch plans never share a file.

File format (version 1)::

    {
      "version": 1,
      "entries": {
        "<key>": {
          "program": "tdfir",
          "backend": "cuda:NVIDIA H100 80GB HBM3",
          "best_pattern": {"fir_bank": "hopper"},
          "pattern": "fir_bank=hopper",
          "speedup": 1.8,
          "baseline_seconds": 0.0123,
          "best_seconds": 0.0068,        # the winner's own measured median
          "strategy": "staged",          # the SearchStrategy that found it
          "loop_count": 4,
          "measured_patterns": ["fir_bank=hopper", ...],
          "measurement_key": "ab12...",  # measurement-compatibility digest
          "measurements": [              # EVERY pattern this search knows,
            {                            # not just the winner — the raw
              "pattern": "fir_bank=hopper",    # material for cross-run
              "impl": {"fir_bank": "hopper"},  # ledger priming
              "run_seconds": 0.0068,
              "compile_seconds": 0.21,
              "ok": true,
              "error": ""
            }
          ],
          "quarantine": [                # cumulative gene strike records
            {"gene": "fir_bank=hopper", "strikes": 2,
             "last_error": "NonFiniteOutput: ..."}
          ],
          "created_at": "2026-07-29T12:00:00+00:00"
        }
      }
    }
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
from datetime import datetime, timezone
from pathlib import Path
from typing import Optional

from repro_torch.core.regions import tuning_space, variants
from repro_torch.core.search import impl_key

CACHE_VERSION = 1
DEFAULT_CACHE_ENV = "REPRO_TORCH_PLAN_CACHE"
DEFAULT_CACHE_PATH = ".repro_torch_plan_cache.json"
_TMP_SEQ = itertools.count()        # per-process unique tmp-file sequence


def _sane_entries(entries: dict) -> dict:
    """Drop per-entry garbage: a corrupt/truncated value inside an
    otherwise-valid file (a concurrent writer died mid-thought, a hand
    edit went wrong) must degrade to a cache-miss for THAT key, never
    crash the reader or poison the healthy entries around it."""
    return {k: v for k, v in entries.items() if isinstance(v, dict)}


def _conditions(program) -> dict:
    """The program's measurement conditions (``cache_extra``) as a key
    part; absent when empty, so keys of programs without any stay as they
    were."""
    extra = getattr(program, "cache_extra", None)
    if not extra:
        return {}
    return {"measurement_conditions": sorted(
        (k, repr(v)) for k, v in extra.items())}


def _static_kwargs(region) -> dict:
    """A region's ``static_kwargs`` as a key part; absent when empty, so
    keys of annotated programs (which have none) stay as they were."""
    if not region.static_kwargs:
        return {}
    return {"static_kwargs": sorted(
        (k, repr(v)) for k, v in region.static_kwargs.items())}


def plan_cache_key(program, config, backend: str) -> str:
    """Deterministic key for (program, abstract shapes, backend, config).

    ``program`` is an OffloadableProgram; ``config`` a PlannerConfig;
    ``backend`` the :func:`~repro_torch.core.device.backend_name` of the
    device the measurements run on.  The registered variant set per region
    is part of the key so that adding a new offload destination (a new
    variant) re-opens the search.
    """
    # measurement-repetition knobs (reps/warmup) and the outlier/quarantine
    # policy change timing noise or failure handling, never which pattern
    # is best: keying on them would make callers miss each other's plans
    _non_key = ("reps", "warmup", "outlier_mad", "remeasure",
                "quarantine_threshold")
    cfg_fields = {k: v for k, v in dataclasses.asdict(config).items()
                  if k not in _non_key}
    # tune_tiles=False searches the variant-only space: the field is dropped.
    # When on, the key additionally carries each variant's declared
    # TuningSpace signature — widening a space re-opens the plan.
    tuned = bool(cfg_fields.get("tune_tiles", False))
    if not tuned:
        cfg_fields.pop("tune_tiles", None)

    def _tuning_signatures(region_name: str) -> dict:
        sigs = {}
        for v in sorted(variants(region_name)):
            space = tuning_space(region_name, v)
            if space is not None:
                sigs[v] = space.signature()
        return sigs

    payload = {
        "program": program.name,
        "backend": backend,
        "config": cfg_fields,
        "regions": [
            {
                "name": r.name,
                "args": r.arg_signature(),
                "variants": sorted(variants(r.name)),
                # rank-key tiebreakers: changing a region's declared
                # preference can change the selected plan, so it re-keys
                "preferred": [r.deploy_variant, r.measure_variant],
                **_static_kwargs(r),
                **({"tuning": _tuning_signatures(r.name)} if tuned else {}),
            }
            for r in program.regions
        ],
        **_conditions(program),
    }
    blob = json.dumps(payload, sort_keys=True, default=repr)
    digest = hashlib.sha256(blob.encode()).hexdigest()[:20]
    return f"{program.name}:{backend}:{digest}"


def measurement_cache_key(program, backend: str) -> str:
    """Measurement-*compatibility* key: two plan runs share it exactly when
    their Step-4 timings are comparable — same program, same backend, same
    region shapes and static kwargs.  Deliberately EXCLUDES everything ``plan_cache_key`` adds
    on top (variant registry, planner budgets, strategy): registering a new
    variant or changing ``d`` re-opens the *search* but does not invalidate
    the *measurements* already taken, so a re-opened search can prime its
    MeasurementLedger from every sibling entry with the same measurement key
    and re-propose known patterns for free.
    """
    payload = {
        "program": program.name,
        "backend": backend,
        "regions": [{"name": r.name, "args": r.arg_signature(),
                     **_static_kwargs(r)}
                    for r in program.regions],
        **_conditions(program),
    }
    blob = json.dumps(payload, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:20]


class PlanCache:
    """JSON-file plan store.  Safe to share between runs; writes are
    atomic (tmp + rename) so a crashed planner never corrupts the file.

    Entries carry two levels of reuse:

    * the full ``plan_cache_key`` match serves the *selected plan* with
      zero new work (``AutoOffloader.plan`` cache hit);
    * on a miss, entries whose ``measurement_key`` matches still donate
      their per-pattern ``measurements`` (``measurements_for``) to prime
      the new search's ledger — previously measured patterns cost zero
      budget even though the search itself re-runs.
    """

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self._data = {"version": CACHE_VERSION, "entries": {}}
        if self.path.exists():
            try:
                loaded = json.loads(self.path.read_text())
                # valid JSON of the wrong shape (null, a list, missing
                # entries) is just as cold as unparseable JSON
                if (isinstance(loaded, dict)
                        and loaded.get("version") == CACHE_VERSION
                        and isinstance(loaded.get("entries"), dict)):
                    loaded["entries"] = _sane_entries(loaded["entries"])
                    self._data = loaded
            except (json.JSONDecodeError, OSError):
                pass                  # unreadable cache = cold cache

    # ------------------------------------------------------------------
    @classmethod
    def default(cls) -> "PlanCache":
        """Cache at $REPRO_TORCH_PLAN_CACHE, else
        ./.repro_torch_plan_cache.json."""
        return cls(os.environ.get(DEFAULT_CACHE_ENV, DEFAULT_CACHE_PATH))

    # ------------------------------------------------------------------
    def get(self, key: str) -> Optional[dict]:
        entry = self._data["entries"].get(key)
        # load-time sanitization drops non-dict entries, but an in-process
        # writer could still have stored one — treat it as a miss, not a crash
        return dict(entry) if isinstance(entry, dict) else None

    def put(self, key: str, entry: dict) -> None:
        entry = dict(entry)
        entry.setdefault("created_at",
                         datetime.now(timezone.utc).isoformat(timespec="seconds"))
        self._data["entries"][key] = entry
        self._flush(merge=True)

    def measurements_for(self, measurement_key: str) -> list[dict]:
        """Every persisted per-pattern measurement from entries taken under
        the same measurement conditions (see ``measurement_cache_key``),
        deduplicated by offload pattern — newest entry wins.  These are the
        dicts ``AutoOffloader`` turns back into ledger-primed Measurements.
        """
        if not measurement_key:
            return []
        by_pattern: dict[tuple, dict] = {}
        entries = sorted(
            (e for e in self._data["entries"].values() if isinstance(e, dict)),
            key=lambda e: str(e.get("created_at", "")))
        for entry in entries:
            if entry.get("measurement_key") != measurement_key:
                continue
            measurements = entry.get("measurements", ())
            if not isinstance(measurements, (list, tuple)):
                continue                          # corrupt field: skip entry
            for m in measurements:
                if not isinstance(m, dict):
                    continue                      # corrupt measurement row
                impl = m.get("impl")
                if not isinstance(impl, dict) or not impl:
                    continue                      # all-ref: re-measured fresh
                try:
                    key = impl_key(impl)          # same identity the ledger uses
                except (TypeError, ValueError):
                    continue                      # un-canonicalizable garbage
                if key:
                    by_pattern[key] = dict(m)
        return list(by_pattern.values())

    def quarantine_for(self, measurement_key: str) -> list[dict]:
        """Merged gene-quarantine strike records from every entry taken
        under the same measurement conditions (see
        ``search.Quarantine.to_records``).  Each persisted record is a
        cumulative snapshot, so the max strike count per gene wins; the
        newest matching entry donates the error string.  A re-opened
        search loads these and skips known-bad variants outright."""
        if not measurement_key:
            return []
        merged: dict[str, dict] = {}
        entries = sorted(
            (e for e in self._data["entries"].values() if isinstance(e, dict)),
            key=lambda e: str(e.get("created_at", "")))
        for entry in entries:
            if entry.get("measurement_key") != measurement_key:
                continue
            records = entry.get("quarantine", ())
            if not isinstance(records, (list, tuple)):
                continue                          # corrupt field: skip entry
            for rec in records:
                if not isinstance(rec, dict):
                    continue
                gene = rec.get("gene")
                try:
                    strikes = int(rec.get("strikes", 0))
                except (TypeError, ValueError):
                    continue
                if not isinstance(gene, str) or strikes <= 0:
                    continue
                prev = merged.get(gene)
                merged[gene] = {
                    "gene": gene,
                    "strikes": max(strikes,
                                   prev["strikes"] if prev else 0),
                    "last_error": str(rec.get("last_error", "")),
                }
        return [merged[g] for g in sorted(merged)]

    def invalidate(self, key: str) -> bool:
        existed = self._data["entries"].pop(key, None) is not None
        if existed:
            self._flush(merge=False)
        return existed

    def clear(self) -> None:
        self._data["entries"] = {}
        self._flush(merge=False)

    def __len__(self) -> int:
        return len(self._data["entries"])

    def __contains__(self, key: str) -> bool:
        return key in self._data["entries"]

    # ------------------------------------------------------------------
    def _flush(self, merge: bool) -> None:
        """Atomic write.  With ``merge``, entries another process wrote to
        the file since we loaded it are kept (our keys win) — two planners
        sharing the default cache must not erase each other's plans.
        invalidate()/clear() flush without merging so deletions stick."""
        if merge and self.path.exists():
            try:
                disk = json.loads(self.path.read_text())
                if (isinstance(disk, dict)
                        and disk.get("version") == CACHE_VERSION
                        and isinstance(disk.get("entries"), dict)):
                    merged = _sane_entries(disk["entries"])
                    merged.update(self._data["entries"])
                    self._data["entries"] = merged
            except (json.JSONDecodeError, OSError):
                pass
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # unique tmp per write: concurrent flushes (threads or processes)
        # must never consume each other's tmp file between write and rename
        tmp = self.path.with_suffix(
            f"{self.path.suffix}.{os.getpid()}.{next(_TMP_SEQ)}.tmp")
        tmp.write_text(json.dumps(self._data, indent=2, sort_keys=True))
        tmp.replace(self.path)


def resolve_cache(cache) -> Optional[PlanCache]:
    """None | path-like | PlanCache -> Optional[PlanCache]."""
    if cache is None or isinstance(cache, PlanCache):
        return cache
    return PlanCache(cache)
