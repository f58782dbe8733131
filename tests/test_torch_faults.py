"""Fault injection and fault-tolerant planning in the port
(``core/faults.py``, ``executor.FaultPolicy``, ``search.Quarantine``),
mirroring tests/test_faults.py's intent on a two-region toy program whose
``offload`` variants are decisively faster than its loop-faithful refs:

* each fault kind at each site is survived or contained as in the JAX
  package: transient faults (a compile hang under ``compile_timeout_s``,
  a flaky run, a slow rep) leave the selected pattern the fault-free one;
  a permanent NaN strikes its gene, which is quarantined, persisted in the
  plan cache under ``measurement_key`` and skipped by the next search;
* ``FaultInjector.fired`` counts equal the JAX injector's for the same
  specs on the same measurement path.

Waits are injected sleeps with wide margins (a hang of seconds against a
timeout well below it and a build of milliseconds); no test compares two
wall-clock times.  The tests that assert which pattern a search selects
time it on ``CostClock``, which only the toy's calls move.
"""
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import executor as JE
from repro.core import faults as JF
from repro.core import search as JS
from repro.core.program import OffloadableProgram as JProgram
from repro.core.program import Region as JRegion
from repro.core.regions import Impl as JImpl
from repro.core.regions import dispatch as jdispatch
from repro.core.regions import register_variant as jregister
from repro.core.regions import variants as jvariants
from repro_torch.core import search as TS
from repro_torch.core.executor import FaultPolicy, measure_with_retry
from repro_torch.core.faults import (DeviceNaN, FaultInjector, FaultSpec,
                                     InjectedFault, wrap_program)
from repro_torch.core.loops import fori_loop
from repro_torch.core.plan_cache import PlanCache, measurement_cache_key
from repro_torch.core.planner import AutoOffloader, PlannerConfig
from repro_torch.core.program import OffloadableProgram, Region, meta
from repro_torch.core.regions import (Impl, dispatch, register_variant,
                                      unregister_variant, variants)

A, B = "tfaults_a", "tfaults_b"


class CostClock:
    """A host clock that moves only when the toy's regions run, by a fixed
    cost a call: a loop-faithful ref 1 s, an offload 1 ms.  Patched into
    the search module by the ``cost_clock`` fixture, it makes a timed search
    pick by these costs and not by the machine's load; elsewhere nothing
    reads it."""
    REF_S, OFFLOAD_S = 1.0, 1e-3

    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        return self.now


CLOCK = CostClock()


def _slow_ref(x):
    CLOCK.now += CostClock.REF_S
    return fori_loop(0, 400, lambda i, acc: acc + 1e-6 * torch.sin(
        acc * 1e-3), x)


def _offload_a(x):
    CLOCK.now += CostClock.OFFLOAD_S
    return x * 1.0000001


def _offload_b(x):
    CLOCK.now += CostClock.OFFLOAD_S
    return x - 1e-7


if not variants(A):
    for name, off in ((A, _offload_a), (B, _offload_b)):
        register_variant(name, "ref")(_slow_ref)
        register_variant(name, "offload")(off)


@pytest.fixture
def cost_clock(monkeypatch):
    """The search module's host clock is ``CLOCK``: each timed call of a
    pattern lasts the sum of its regions' costs."""
    monkeypatch.setattr(TS, "time", types.SimpleNamespace(
        perf_counter=CLOCK.perf_counter))
    return CLOCK


def _toy_program() -> OffloadableProgram:
    def build(impl):
        def run(x):
            return dispatch(B, impl, dispatch(A, impl, x))
        return run

    def sample(seed, dev):
        g = torch.Generator().manual_seed(seed)
        return (torch.randn(128, 128, generator=g).to(dev),)

    abstract = (meta((128, 128), torch.float32),)
    return OffloadableProgram(
        name="tfaults_toy", regions=[Region(A, variants(A)["ref"], abstract),
                                     Region(B, variants(B)["ref"], abstract)],
        build=build, sample_inputs=sample, device=torch.device("cpu"),
        source_loop_count=2)


def _jax_toy():
    ja, jb = "tfaults_jax_a", "tfaults_jax_b"
    if not jvariants(ja):
        def slow(x):
            return jax.lax.fori_loop(
                0, 400, lambda i, acc: acc + 1e-6 * jnp.sin(acc * 1e-3), x)
        for name, off in ((ja, lambda x: x * 1.0000001),
                          (jb, lambda x: x - 1e-7)):
            jregister(name, "ref")(slow)
            jregister(name, "offload")(off)

    def build(impl):
        def run(x):
            return jdispatch(jb, impl, jdispatch(ja, impl, x))
        return run

    abstract = (jax.ShapeDtypeStruct((128, 128), jnp.float32),)
    return JProgram(name="tfaults_jax_toy",
                    regions=[JRegion(ja, jvariants(ja)["ref"], abstract),
                             JRegion(jb, jvariants(jb)["ref"], abstract)],
                    build=build,
                    sample_inputs=lambda k: (jax.random.normal(k, (128, 128)),),
                    source_loop_count=2), ja, jb


CLEAN = {A: "offload", B: "offload"}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the refs' small ops do not oversubscribe a
    machine shared with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    kw.setdefault("reps", 3)
    kw.setdefault("warmup", 1)
    kw.setdefault("retry_backoff_s", 0.0)
    return PlannerConfig(**kw)


# ---------------------------------------------------------------------------
# the injector (tests/test_faults.py)
# ---------------------------------------------------------------------------
def test_injector_fires_as_the_jax_injector():
    specs = [("nan", "run", "", 2, True), ("exception", "compile", "a=off",
                                           0, False), ("flaky", "run", "b=", 1,
                                                       True)]
    calls = [("run", "p1"), ("run", "p1"), ("run", "p1"), ("run", "p2"),
             ("compile", "a=offload"), ("compile", "b=offload"),
             ("run", "b=offload"), ("run", "b=offload"), ("compile", "x")]
    logs = []
    for mod in (JF, __import__("repro_torch.core.faults", fromlist=["x"])):
        inj = mod.FaultInjector(specs=[mod.FaultSpec(k, site=s, match=m,
                                                     times=t, transient=tr)
                                       for k, s, m, t, tr in specs])
        raised = []
        for site, key in calls:
            try:
                inj.fire(site, key)
            except RuntimeError as e:
                raised.append(str(e))
        logs.append((inj.log, raised, inj.fired(), inj.fired("nan")))
        inj.reset()
        assert inj.fired() == 0
    assert logs[0] == logs[1]
    with pytest.raises(ValueError):
        FaultSpec("meteor")
    with pytest.raises(ValueError):
        FaultSpec("nan", site="orbit")


def test_injected_fault_messages_classify_as_in_jax():
    for kind, transient in (("flaky", True), ("exception", False),
                            ("exception", True)):
        msg = str(InjectedFault(kind, "run", "p", transient=transient))
        assert msg == str(JF.InjectedFault(kind, "run", "p",
                                           transient=transient))
        assert TS.classify_failure(msg) == JS.classify_failure(msg)


def test_watchdog_expires_and_classifies_transient():
    ok, val, err = TS.watchdog_call(lambda: 42, timeout_s=5.0)
    assert ok and val == 42 and err == ""
    ev = threading.Event()
    ok, _, err = TS.watchdog_call(ev.wait, (5.0,), timeout_s=0.1)
    assert not ok and "WatchdogTimeout" in err
    assert TS.classify_failure(err) == "transient"
    ev.set()


# ---------------------------------------------------------------------------
# the measurement path, fault by fault, fired counts against JAX's
# ---------------------------------------------------------------------------
def _measure_torch(spec, policy, *, reps=3, warmup=1):
    inj = FaultInjector(specs=[spec])
    wrapped = wrap_program(_toy_program(), inj)
    args = wrapped.sample_inputs(0, torch.device("cpu"))
    impl = Impl(CLEAN)

    def once():
        art = TS.compile_pattern(lambda: wrapped.build(impl),
                                 timeout_s=policy.compile_timeout_s)
        return TS.time_callable(
            None, args, warmup=warmup, reps=reps, pattern=impl.describe(),
            impl=dict(impl), precompiled=art,
            run_timeout_s=policy.run_timeout_s, check_finite=True,
            outlier_mad=policy.outlier_mad, remeasure=policy.remeasure), True

    return measure_with_retry(once, policy), inj


def _measure_jax(spec_kw, *, reps=3, warmup=1, **policy_kw):
    prog, ja, jb = _jax_toy()
    inj = JF.FaultInjector(specs=[JF.FaultSpec(**{
        **spec_kw, "match": spec_kw.get("match", "").replace(A, ja)})])
    wrapped = JF.wrap_program(prog, inj)
    fn = wrapped.build(JImpl({ja: "offload", jb: "offload"}))
    args = wrapped.sample_inputs(jax.random.PRNGKey(0))
    policy = JE.FaultPolicy(retry_backoff_s=0.0, **policy_kw)

    def once():
        return JS.time_callable(
            fn, args, warmup=warmup, reps=reps,
            compile_timeout_s=policy.compile_timeout_s,
            run_timeout_s=policy.run_timeout_s, check_finite=True,
            outlier_mad=policy.outlier_mad, remeasure=policy.remeasure), True

    return JE.measure_with_retry(once, policy), inj


@pytest.mark.parametrize("spec_kw,policy_kw,want", [
    # a flaky run: fails once, the retry succeeds
    ({"kind": "flaky", "site": "run", "times": 1}, {}, (True, 2, "")),
    # a permanent NaN: never retried
    ({"kind": "nan", "site": "run", "times": 0, "transient": False}, {},
     (False, 1, "permanent")),
    # a permanent exception in the compile step
    ({"kind": "exception", "site": "compile", "times": 0,
      "transient": False}, {}, (False, 1, "permanent")),
    # a slow first timed rep (fire 1 = the first call): MAD-rejected
    ({"kind": "slow", "site": "run", "times": 2, "delay_s": 0.4}, {},
     (True, 1, "")),
    # a compile hang of 2.5 s under a 2 s watchdog: abandoned, retried (the
    # JAX retry waits for the abandoned trace to finish, so the hang ends
    # well inside the retry's own 2 s)
    ({"kind": "hang", "site": "compile", "times": 1, "delay_s": 2.5},
     {"compile_timeout_s": 2.0}, (True, 2, "")),
], ids=["flaky", "nan", "compile-exception", "slow-rep", "compile-hang"])
def test_each_fault_on_the_measurement_path_as_in_jax(spec_kw, policy_kw, want):
    m, inj = _measure_torch(FaultSpec(**spec_kw), FaultPolicy(
        retry_backoff_s=0.0, **policy_kw))
    assert (m.ok, m.attempts, m.failure_kind if not m.ok else "") == want
    jm, jinj = _measure_jax(spec_kw, **policy_kw)
    assert (jm.ok, jm.attempts) == (m.ok, m.attempts)
    assert inj.fired() == jinj.fired() and inj.log[0][2] == jinj.log[0][2]
    if spec_kw["kind"] == "slow":
        assert m.outliers_rejected >= 1 and max(m.runs) >= 0.4
        assert m.run_seconds < 0.4
    if spec_kw["kind"] == "nan":
        assert "NonFiniteOutput" in m.error and m.failure_phase == "run"
    if spec_kw["kind"] == "exception":
        assert m.failure_phase == "compile" and "InjectedFault" in m.error


def test_run_hang_times_out_transient_and_drains():
    m, inj = _measure_torch(
        FaultSpec("hang", site="run", delay_s=6.0, times=1),
        FaultPolicy(run_timeout_s=2.0, retry_backoff_s=0.0))
    # the first call hung past the watchdog: transient, drained, retried
    assert m.ok and m.attempts == 2 and m.drained
    assert inj.fired("hang") == 1


# ---------------------------------------------------------------------------
# whole plans under faults: same winner, quarantine persisted and honoured
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("workers", [1, 3])
def test_plan_same_winner_under_transient_faults(workers):
    # exhaustive at d=3 measures every pattern, so the winner does not
    # hinge on a single region's 2x beating the baseline in round 1
    prog = _toy_program()
    cfg = _cfg(verify_workers=workers, compile_timeout_s=2.0,
               run_timeout_s=10.0, strategy="exhaustive", max_measurements=3)
    clean = AutoOffloader(cfg).plan(prog)
    assert clean.best_pattern == CLEAN
    inj = FaultInjector(specs=[
        FaultSpec("hang", site="compile", match=f"{A}=offload", times=1,
                  delay_s=6.0),
        FaultSpec("flaky", site="run", times=1),
        FaultSpec("slow", site="run", match=f"{B}=offload", times=2,
                  delay_s=0.4)])
    faulted = AutoOffloader(cfg).plan(wrap_program(prog, inj))
    assert inj.fired("hang") >= 1 and inj.fired("flaky") >= 1
    assert inj.fired("slow") >= 1
    assert faulted.best_pattern == clean.best_pattern
    assert faulted.quarantined == []          # transient faults never strike
    ms = faulted.measurements + [faulted.baseline]
    assert max(m.attempts for m in ms) >= 2
    assert any(m.outliers_rejected for m in ms)
    assert "attempts]" in faulted.summary()


def test_nan_gene_quarantined_persisted_and_skipped(tmp_path, cost_clock):
    prog = _toy_program()
    gene = f"{A}=offload"
    inj = FaultInjector(specs=[FaultSpec("nan", site="run", match=gene,
                                         times=0, transient=False)])
    wrapped = wrap_program(prog, inj)
    cache = PlanCache(tmp_path / "plans.json")
    rep = AutoOffloader(_cfg(quarantine_threshold=1)).plan(wrapped,
                                                           cache=cache)
    assert gene in rep.quarantined and rep.quarantine_records
    assert rep.best_pattern == {B: "offload"}     # the healthy gene wins
    recs = cache.quarantine_for(measurement_cache_key(wrapped, "cpu"))
    assert any(r["gene"] == gene and r["strikes"] >= 1 for r in recs)
    q = TS.Quarantine(threshold=1)
    q.load_records(recs)
    assert q.is_quarantined(A, "offload")
    # another strategy: a new plan key, the same measurement key — the
    # struck gene is never proposed again, and never runs
    fired = inj.fired()
    rep2 = AutoOffloader(_cfg(strategy="exhaustive", quarantine_threshold=1)
                         ).plan(wrapped, cache=cache)
    assert not rep2.from_cache and gene in rep2.quarantined
    assert all(gene not in m.pattern for m in rep2.measurements)
    assert inj.fired() == fired


def test_preloaded_quarantine_filters_proposals(cost_clock):
    off = AutoOffloader(_cfg(quarantine_threshold=1))
    off.quarantine.record_failure({A: "offload"}, "known bad")
    assert off.quarantine.strikes() == {f"{A}=offload": 1}
    rep = off.plan(_toy_program())
    assert f"{A}=offload" in rep.quarantined
    assert all(f"{A}=offload" not in m.pattern for m in rep.measurements)
    assert rep.best_pattern == {B: "offload"}


def test_ledger_refunds_and_records_failures():
    calls = [0]

    def measure_fn(impl):
        calls[0] += 1
        if calls[0] == 1:
            raise InjectedFault("flaky", "run", "p", transient=True)
        return TS.Measurement("p", 0.0, float("inf"), [], False,
                              "InjectedFault[nan/permanent]", impl=dict(impl))

    q = TS.Quarantine(threshold=2)
    led = TS.MeasurementLedger(measure_fn=measure_fn, budget=3, quarantine=q)
    with pytest.raises(InjectedFault):
        led.measure({"r": "hopper"})
    assert led.budget == 3 and led.misses == 0 and not led._inflight
    led.measure({"r": "hopper"})
    led.measure({"r": "hopper", "s": "hopper"})
    assert q.is_quarantined("r", "hopper") and q.strikes()["s=hopper"] == 1
    assert len(led.failures()) == 2 and led.seen({"r": "hopper"})


def test_device_nan_variant_writes_nan_while_armed():
    fault = DeviceNaN(B, base="offload", name="nan_probe")
    try:
        fn = _toy_program().build(Impl({B: "nan_probe"}))
        x = torch.ones(128, 128)
        assert bool(torch.isfinite(fn(x)).all())
        fault.arm()
        assert bool(torch.isnan(fn(x)).all())
        fault.disarm()
        np.testing.assert_array_equal(
            fn(x).numpy(), _toy_program().build(Impl({B: "offload"}))(x).numpy())
    finally:
        fault.close()
    assert "nan_probe" not in variants(B)
    unregister_variant(B, "nan_probe")          # idempotent
