"""Deterministic fault injection for the compile/measure/serve seams.

The paper's Step-4 verification measures candidate patterns on real
hardware, and real verification environments are hostile: builds hang,
kernels crash, accelerators return garbage, and timings are noisy.  The
fault-tolerance layer (``search.watchdog_call`` / ``classify_failure`` /
``Quarantine``, ``executor.FaultPolicy``, the ServeEngine's runtime guard)
exists for those environments; this module is how tests and the card's
smoke run exercise it without owning broken hardware.

:class:`FaultInjector` holds a list of :class:`FaultSpec` rules and fires
them **deterministically**: a spec matches a (site, pattern-key) call, keeps
a per-key fire counter, and stops firing after ``times`` hits — so a
``flaky`` spec fails a pattern exactly N times and then lets it succeed,
which is what bounded retry must survive.  No clock and no RNG decide a
fire; two runs over the same proposal sequence inject the same faults.

:func:`wrap_program` returns a program whose built patterns consult the
injector at both seams of a measurement:

* ``site="compile"`` faults fire inside ``build(impl)`` — the compile step
  (``search.compile_pattern``), inside the compile watchdog's scope: a
  ``hang`` sleeps there, an ``exception`` raises out of it.
* ``site="run"`` faults fire in a host hook on the built callable's output,
  on *every* call: ``hang``/``slow`` sleep on the host after the call's
  launches (a CUDA-event rep then spans the sleep), ``nan`` replaces the
  first floating tensor of the output with NaNs on its device (caught by
  the finite check), and ``exception``/``flaky`` raise.  The built callable
  carries the two halves apart, ``inner`` (the pattern) and ``seam`` (the
  hook), so Step 4 captures ``inner`` into a CUDA graph and puts every
  replay's outputs through ``seam`` on the host: a run-site fault fires per
  replay as it fires per eager call (captured, it would fire once, at
  capture).

A served generation replays CUDA graphs of its own steps, which no host
hook sees.  Its fault seam is device work inside the graph instead:
:class:`DeviceNaN` registers a variant that runs a region's variant and
then writes NaN over its output when a flag on the device is set.

Injected errors carry a ``transient`` or ``permanent`` marker in their
message; :func:`repro_torch.core.search.classify_failure` keys off it.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

KINDS = ("hang", "exception", "nan", "slow", "flaky")
SITES = ("compile", "run")


class InjectedFault(RuntimeError):
    """Raised by ``exception``/``flaky`` specs.  The message embeds the
    kind and a ``transient``/``permanent`` marker so string-level
    classification still sees the intent:
    ``InjectedFault[flaky/transient] at run for fir_bank=hopper``."""

    def __init__(self, kind: str, site: str, key: str, transient: bool):
        self.kind = kind
        self.site = site
        self.key = key
        self.transient = transient
        marker = "transient" if transient else "permanent"
        super().__init__(
            f"InjectedFault[{kind}/{marker}] at {site} for {key or 'any'}")


@dataclass(frozen=True)
class FaultSpec:
    """One injection rule.

    kind:      ``hang`` / ``exception`` / ``nan`` / ``slow`` / ``flaky``.
    site:      ``compile`` (fires in the compile step) or ``run`` (fires on
               every call of the built pattern).
    match:     substring of the pattern key (``Impl.describe()`` rendering);
               ``""`` matches every call at the site.
    times:     per-key fire budget; after ``times`` fires on a key the spec
               goes quiet for that key (``flaky`` = fail-then-succeed).
               ``times <= 0`` fires forever.
    delay_s:   sleep for ``hang``/``slow`` (a hung worker thread is
               abandoned, not killed).
    transient: classification marker carried in the injected error message;
               ``flaky`` is always transient by definition.
    """
    kind: str
    site: str = "run"
    match: str = ""
    times: int = 1
    delay_s: float = 0.25
    transient: bool = True

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {KINDS}")
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; one of {SITES}")


@dataclass
class FaultInjector:
    """Deterministic firing engine over a list of specs.

    ``seed`` exists so two injectors configured identically are
    interchangeable; firing itself is counter-based (first matching spec
    with budget left), never random.  Thread-safe: the executor compiles
    concurrently and specs keep exact per-key counters under a lock.
    """
    specs: tuple = ()
    seed: int = 0
    log: list = field(default_factory=list)   # (site, key, kind) fire log
    _fired: dict = field(default_factory=dict)  # (spec idx, key) -> count
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def __post_init__(self):
        self.specs = tuple(self.specs)

    def _take(self, site: str, key: str) -> Optional[FaultSpec]:
        """Consume one fire from the first matching spec with budget left
        for ``key`` (None = no fault at this call)."""
        with self._lock:
            for i, s in enumerate(self.specs):
                if s.site != site or (s.match and s.match not in key):
                    continue
                n = self._fired.get((i, key), 0)
                if s.times > 0 and n >= s.times:
                    continue
                self._fired[(i, key)] = n + 1
                self.log.append((site, key, s.kind))
                return s
        return None

    def fire(self, site: str, key: str) -> Optional[FaultSpec]:
        """Enact a host-side fault at (site, key): ``hang``/``slow`` sleep,
        ``exception``/``flaky`` raise :class:`InjectedFault`.  ``nan`` is
        returned to the caller, which corrupts its output itself."""
        s = self._take(site, key)
        if s is None:
            return None
        if s.kind in ("hang", "slow"):
            time.sleep(s.delay_s)
            return s
        if s.kind in ("exception", "flaky"):
            raise InjectedFault(s.kind, site, key,
                                transient=s.transient or s.kind == "flaky")
        return s    # "nan": the caller replaces its output

    def fired(self, kind: Optional[str] = None) -> int:
        """Total fires so far (optionally of one kind)."""
        with self._lock:
            return sum(1 for _, _, k in self.log if kind is None or k == kind)

    def reset(self) -> None:
        with self._lock:
            self._fired.clear()
            self.log.clear()


def _inject_run_faults(out, key: str, injector: FaultInjector):
    """The run-site seam on one call's output: consult the injector
    (sleeping or raising as the spec says) and, for ``nan``, replace the
    first floating or complex tensor of the output with NaNs on its
    device.  A call on meta tensors (the planner's counting pass) is
    analysis, not a run: no fault fires."""
    if any(isinstance(t, torch.Tensor) and t.is_meta
           for t in tree_flatten(out)[0]):
        return out
    spec = injector.fire("run", key)
    if spec is None or spec.kind != "nan":
        return out
    leaves, spec_tree = tree_flatten(out)
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor) and (leaf.is_floating_point()
                                               or leaf.is_complex()):
            leaves[i] = torch.full_like(leaf, float("nan"))
            return tree_unflatten(leaves, spec_tree)
    return out


def wrap_program(program, injector: FaultInjector):
    """A copy of ``program`` whose built patterns consult ``injector``.

    Compile-site faults fire in ``build(impl)``; run-site faults fire on
    every call of the built pattern, and on every replay of a graph
    captured from its ``inner`` half when the replay's outputs go through
    its ``seam`` half (as ``search.time_callable`` does).  The pattern key
    handed to the
    injector is the build ``Impl``'s :meth:`~repro_torch.core.regions
    .Impl.describe` rendering (``"all-ref"`` for the empty pattern), so
    specs can target one candidate by substring match.
    """
    from repro_torch.core.regions import Impl

    inner_build = program.build

    def build(impl):
        key = Impl(dict(impl)).describe()
        injector.fire("compile", key)
        fn = inner_build(impl)

        def seam(out):
            return _inject_run_faults(out, key, injector)

        def faulty(*args):
            return seam(fn(*args))

        faulty.inner, faulty.seam = fn, seam
        return faulty

    return dataclasses.replace(program, build=build)


class DeviceNaN:
    """A device-side fault seam for served generations.

    Registers ``region``'s variant ``name`` that runs ``base`` and then
    ``torch.where(flag, NaN, out)`` with ``flag`` a boolean tensor on the
    output's device: device work, so a CUDA graph captured through it
    writes NaN at every replay while the flag is set.  ``arm()`` /
    ``disarm()`` set the flag (one small host-to-device copy each);
    ``close()`` unregisters the variant."""

    def __init__(self, region: str, base: str = "ref", name: str = "nan"):
        from repro_torch.core.regions import register_variant, variants
        self.region, self.name = region, name
        self._flags: dict = {}
        self._armed = False
        base_fn = variants(region)[base]

        def poisoned(*args, **kwargs):
            out = base_fn(*args, **kwargs)
            return torch.where(self._flag(out.device), float("nan"), out)

        register_variant(region, name)(poisoned)

    def _flag(self, device) -> torch.Tensor:
        device = torch.device(device)
        flag = self._flags.get(device)
        if flag is None:
            flag = torch.tensor(self._armed, device=device)
            self._flags[device] = flag
        return flag

    def _set(self, value: bool) -> None:
        self._armed = value
        for flag in self._flags.values():
            flag.fill_(value)

    def arm(self) -> None:
        self._set(True)

    def disarm(self) -> None:
        self._set(False)

    def close(self) -> None:
        from repro_torch.core.regions import unregister_variant
        unregister_variant(self.region, self.name)
