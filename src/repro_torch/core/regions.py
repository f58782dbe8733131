"""Offloadable regions — the port's counterpart of the paper's "loop statements".

The paper enumerates loop statements of a C program and generates, per loop,
an OpenCL kernel/host split.  Here a *region* is a named compute function with
one or more *variants*:

* ``ref``     — the loop-faithful / plain-PyTorch implementation (the "CPU
                host" side; always present, used as the oracle),
* ``offload`` — the restructured implementation in plain PyTorch
                (vectorized — what the hand-written kernel computes),
                timeable on any device,
* ``hopper``  — the hand-written CUDA kernel for the H100 (its wrapper runs
                the kernel's plain PyTorch version on CPU or meta tensors).

An *offload pattern* (paper §3.3) is a mapping ``{region -> gene}``; the
planner searches over patterns.  A gene is either a bare variant name
(``"hopper"``) or a ``(variant, params)`` pair carrying tile parameters —
the paper resizes the offloaded loop itself (unroll factor ``b``, pipeline
clauses) to fit the device, and a variant that wants the planner to search
its tile knobs declares a :class:`TuningSpace` next to its registration.

Canonicalization rule: params equal to the declared defaults are dropped,
so ``{r: ("hopper", {"block_n": 512})}`` (512 the default) and
``{r: "hopper"}`` are the *same gene* — same hash, same ledger entry, same
plan-cache identity.  The rule and the renderings (:meth:`Impl.describe`,
:func:`canonical_gene`) are string-for-string those of the JAX package, so
plan-cache keys built from them agree across the two.

The registry is the port's own: the JAX package registers its variants
under the same region names in a registry of its own.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
from dataclasses import dataclass
from typing import Callable, Optional

REGISTRY: dict[str, dict[str, Callable]] = {}
_VERSION = [0]           # bumped by every (un)registration
_OBSERVED = threading.local()   # .seen: regions dispatched on this thread

# (region, variant) -> TuningSpace for variants that declared tile knobs
_TUNING: dict[tuple[str, str], "TuningSpace"] = {}


@dataclass(frozen=True, init=False)
class TuningSpace:
    """Discrete tile-parameter space of one kernel variant.

    Declared next to the variant's registration
    (``register_variant(region, variant, tuning=TuningSpace(...))``) so
    the planner can widen the genome from ``{region -> variant}`` to
    ``{region -> (variant, params)}`` — the paper's loop-resizing knobs
    (unroll ``b``, tile sizes) made first-class search genes.

    Parameters
    ----------
    axes:
        ``{name: ordered value tuple}`` (or an iterable of pairs).  The
        order within an axis defines the tuner's neighbor steps.
    defaults:
        Per-axis default value (missing axes default to their first
        value).  MUST match the variant function's own keyword defaults:
        a gene whose params equal the defaults canonicalizes to the bare
        variant, so defaulted and bare genes share one identity.
    validity:
        Optional predicate ``fn(full_params: dict, args) -> bool`` ruling
        points in/out for the region's abstract ``args`` (shape
        divisibility, shared-memory footprint).  ``args`` may be ``None`` for
        unbound queries.  Legality lives HERE, in one place — kernels
        clamp rather than assert, so any proposed point still runs.
    """
    axes: tuple
    defaults: tuple
    validity: Optional[Callable] = None

    def __init__(self, axes, defaults=None, validity=None):
        pairs = axes.items() if isinstance(axes, dict) else axes
        ax = tuple((str(name), tuple(vals)) for name, vals in pairs)
        dmap = dict(defaults or {})
        dflt = tuple((name, dmap.get(name, vals[0])) for name, vals in ax)
        object.__setattr__(self, "axes", ax)
        object.__setattr__(self, "defaults", dflt)
        object.__setattr__(self, "validity", validity)

    # -- basic views ---------------------------------------------------
    def names(self) -> tuple:
        return tuple(name for name, _ in self.axes)

    def default_params(self) -> dict:
        return dict(self.defaults)

    def full(self, params) -> dict:
        """Defaults overlaid with the known axes of ``params``."""
        p = self.default_params()
        for k, v in dict(params or {}).items():
            if k in p:
                p[k] = v
        return p

    def canonical(self, params) -> tuple:
        """The non-default entries of ``params`` as ``((name, value), ...)``
        in declared axis order — empty exactly when the point IS the
        default, which is what collapses defaulted genes onto bare ones."""
        d = self.default_params()
        p = dict(params or {})
        return tuple((name, p[name]) for name, _ in self.axes
                     if name in p and p[name] != d[name])

    # -- legality ------------------------------------------------------
    def is_valid(self, params, args=None) -> bool:
        p = self.full(params)
        for name, vals in self.axes:
            if p[name] not in vals:
                return False
        if self.validity is not None:
            try:
                return bool(self.validity(p, args))
            except Exception:  # noqa: BLE001 — an erroring predicate = invalid
                return False
        return True

    def points(self, args=None) -> list[dict]:
        """Every valid full-param point, deterministic (product) order."""
        names = self.names()
        out = []
        for combo in itertools.product(*(vals for _, vals in self.axes)):
            p = dict(zip(names, combo))
            if self.is_valid(p, args):
                out.append(p)
        return out

    def size(self, args=None) -> int:
        return len(self.points(args))

    def neighbors(self, params, args=None) -> list[dict]:
        """Valid one-axis ±1 steps (within each axis's declared order)
        around ``params`` — the tuner's neighbor-step mutation moves."""
        p = self.full(params)
        out = []
        for name, vals in self.axes:
            try:
                i = vals.index(p[name])
            except ValueError:
                i = 0
            for j in (i - 1, i + 1):
                if 0 <= j < len(vals):
                    q = dict(p)
                    q[name] = vals[j]
                    if self.is_valid(q, args):
                        out.append(q)
        return out

    def signature(self) -> list:
        """JSON-safe identity for plan-cache keys: axes, values, defaults
        (the validity code deliberately excluded — tightening a predicate
        prunes points but does not invalidate measured ones)."""
        d = self.default_params()
        return [[name, list(vals), d[name]] for name, vals in self.axes]


@dataclass(frozen=True)
class BoundTuningSpace:
    """A :class:`TuningSpace` closed over a region's abstract args, so
    search strategies can enumerate/step points without carrying shapes."""
    space: TuningSpace
    args: tuple = ()

    def default_params(self) -> dict:
        return self.space.default_params()

    def canonical(self, params) -> tuple:
        return self.space.canonical(params)

    def full(self, params) -> dict:
        return self.space.full(params)

    def is_valid(self, params) -> bool:
        return self.space.is_valid(params, self.args)

    def points(self) -> list[dict]:
        return self.space.points(self.args)

    def size(self) -> int:
        return self.space.size(self.args)

    def neighbors(self, params) -> list[dict]:
        return self.space.neighbors(params, self.args)


def register_variant(region: str, variant: str,
                     tuning: TuningSpace | None = None) -> Callable:
    def deco(fn: Callable) -> Callable:
        REGISTRY.setdefault(region, {})[variant] = fn
        if tuning is not None:
            _TUNING[(region, variant)] = tuning
        _VERSION[0] += 1
        return fn
    return deco


def unregister_variant(region: str, variant: str) -> bool:
    """Remove one variant registration (and its TuningSpace).  Primarily
    for tests that register throwaway variants on real regions and must not
    pollute later searches; returns whether the variant existed."""
    table = REGISTRY.get(region)
    existed = table is not None and table.pop(variant, None) is not None
    if table is not None and not table:
        REGISTRY.pop(region, None)
    _TUNING.pop((region, variant), None)
    _VERSION[0] += 1
    return existed


def registry_version() -> int:
    """Monotone counter of variant (un)registrations: a compiled pattern is
    reusable only under the registry it was built from
    (``core/executor.py::compile_key``)."""
    return _VERSION[0]


@contextlib.contextmanager
def observe_dispatch():
    """Collect the regions :func:`dispatch` reaches on THIS thread while
    the block runs (the serving canary asks which regions a decode step
    touches).  Yields the set, filled in place."""
    prev = getattr(_OBSERVED, "seen", None)
    seen: set = set()
    _OBSERVED.seen = seen
    try:
        yield seen
    finally:
        _OBSERVED.seen = prev


def tuning_space(region: str, variant: str) -> Optional[TuningSpace]:
    """The TuningSpace a variant declared at registration, or None."""
    return _TUNING.get((region, variant))


def variants(region: str) -> dict[str, Callable]:
    return dict(REGISTRY.get(region, {}))


def offload_variants(region: str) -> dict[str, Callable]:
    """Every registered non-ref variant — the destinations the mixed-pattern
    planner searches over (``ref`` is the host side, never an offload)."""
    return {v: fn for v, fn in REGISTRY.get(region, {}).items() if v != "ref"}


# ---------------------------------------------------------------------------
# Genes: bare variant names or (variant, params) pairs
# ---------------------------------------------------------------------------
def split_gene(value) -> tuple[str, dict]:
    """``(variant, params)`` view of one Impl gene value.  Accepts the bare
    variant string, a ``(variant, params_dict)`` pair, or the JSON
    round-trip forms (lists; params as a list of ``[name, value]`` pairs)
    — plan-cache entries written before tile genes existed parse as bare
    variants with empty params."""
    if isinstance(value, str):
        return value, {}
    if isinstance(value, (tuple, list)) and len(value) == 2:
        name, params = value
        if isinstance(params, dict):
            return str(name), dict(params)
        try:
            return str(name), {str(k): v for k, v in params}
        except (TypeError, ValueError):
            return str(name), {}
    return str(value), {}


def gene_variant(value) -> str:
    """The variant name of a gene value, params dropped."""
    return split_gene(value)[0]


def canonical_gene(region: str, value):
    """Canonical gene value: the bare variant string when the params equal
    the variant's declared defaults (or it declared no TuningSpace), else
    ``(variant, ((name, value), ...))`` with only the non-default entries.
    This single rule makes defaulted-param genes hash/dedup identically to
    bare ones everywhere (ledger, compile cache, plan cache)."""
    name, params = split_gene(value)
    if not params:
        return name
    space = _TUNING.get((region, name))
    if space is None:
        return name
    canon = space.canonical(params)
    return name if not canon else (name, canon)


class Impl(dict):
    """A chosen offload pattern: region name -> gene (default 'ref').

    A gene is a bare variant name or a ``(variant, params)`` pair (see
    :func:`split_gene`); ``pick`` keeps returning the variant *name* for
    callers that only route, ``gene`` returns the full (variant, params)
    view the dispatcher and the tuner use."""

    def pick(self, region: str) -> str:
        return gene_variant(self.get(region, "ref"))

    def gene(self, region: str) -> tuple[str, dict]:
        return split_gene(self.get(region, "ref"))

    def describe(self) -> str:
        parts = []
        for r in sorted(self):
            g = canonical_gene(r, self[r])
            name, params = split_gene(g)
            if name == "ref":
                continue
            if params:
                inner = ",".join(f"{k}={v}" for k, v in sorted(params.items()))
                parts.append(f"{r}={name}[{inner}]")
            else:
                parts.append(f"{r}={name}")
        return "+".join(parts) or "all-ref"


def dispatch(region: str, impl: Optional[Impl], *args, **kwargs):
    seen = getattr(_OBSERVED, "seen", None)
    if seen is not None:
        seen.add(region)
    choice, params = impl.gene(region) if impl else ("ref", {})
    table = REGISTRY.get(region)
    if table is None:
        raise KeyError(f"unknown region {region!r}")
    if choice not in table:
        raise KeyError(f"region {region!r} has no variant {choice!r}; has {sorted(table)}")
    if params:
        # gene params are the variant's configuration: they win over caller
        # kwargs, and only the declared tuning axes pass through
        space = _TUNING.get((region, choice))
        if space is not None:
            known = set(space.names())
            params = {k: v for k, v in params.items() if k in known}
        kwargs = {**kwargs, **params}
    return table[choice](*args, **kwargs)
