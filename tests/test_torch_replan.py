"""Online replanning in the port (``serving/replan.py``, the engine's
canary, runtime guard and rollback) against the JAX package's, on reduced
recurrentgemma-2b and Mistral-NeMo-12B in float32 with the same converted
parameters and the same scripted traffic (tests/serving_harness.py):

* a drift-triggered replanner fires on the same tick, swaps on the same
  tick and counts the same ``swaps``/``rollbacks``/``degraded`` in both
  packages, and the greedy streams equal the JAX engine's and a
  never-swapped twin's;
* a generation that writes NaN (a device-side fault inside its steps) is
  rolled back within its tick with no request dropped, in both packages;
* the canary rejects scaled logits and NaN and accepts a correct
  candidate — bit-equal where the decode arithmetic is the same, within
  the stated noise tolerance where it is not;
* ``conditions_from_stats`` equals JAX's, and ``plan_extra`` re-keys the
  plan but not the measurements: a warm re-open spends 0 measurements.

Greedy streams are compared with both unembeddings in float32, as in
tests/test_torch_generations.py.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from serving_harness import (DRIFT_SHORT_TO_LONG, Phase, ScriptedTraffic,
                             assert_streams_equal, check_conservation, drive,
                             streams)

from repro.configs import get_config as jax_get_config
from repro.core.planner import conditions_from_stats as jax_conditions
from repro.core.regions import register_variant as jregister
from repro.core.regions import unregister_variant as junregister
from repro.core.regions import variants as jvariants
from repro.models import factory as JF
from repro.models import layers as JL
from repro.serving.engine import ServeEngine as JaxEngine
from repro.serving.replan import DriftConfig as JDriftConfig
from repro.serving.replan import DriftDetector as JDriftDetector
from repro.serving.replan import ReplanConfig as JReplanConfig
from repro.serving.replan import Replanner as JReplanner
from repro_torch.configs.base import get_config
from repro_torch.core.faults import DeviceNaN
from repro_torch.core.plan_cache import (PlanCache, measurement_cache_key,
                                         plan_cache_key)
from repro_torch.core.planner import (AutoOffloader, PlannerConfig,
                                      conditions_from_stats)
from repro_torch.core.regions import (Impl, register_variant,
                                      unregister_variant, variants)
from repro_torch.core.search import Quarantine
from repro_torch.launch.serve import make_replan_fn
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.offload_program import make_lm_program
from repro_torch.serving.engine import (_FALLBACK_CAPACITY,
                                        CANARY_TOL_MIN, PlanFault,
                                        ServeEngine)
from repro_torch.serving.replan import (DriftConfig, DriftDetector,
                                        ReplanConfig, Replanner)

ARCHS = ("recurrentgemma-2b", "mistral-nemo-12b")
PROBE = {"replan_probe": "offload"}     # a region no block dispatches
_MODELS: dict = {}


def _model(arch: str):
    """(jcfg, tcfg, jparams, tparams), float32, built once per arch."""
    if arch not in _MODELS:
        jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                                   dtype="float32")
        tcfg = dataclasses.replace(get_config(arch).reduced(),
                                   dtype="float32")
        jparams = JF.init_params(jcfg, jax.random.PRNGKey(7))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        _MODELS[arch] = (jcfg, tcfg, jparams, tparams)
    return _MODELS[arch]


def _engines(arch, *, slots=2, ctx=32):
    jcfg, tcfg, jparams, tparams = _model(arch)
    return (JaxEngine(jcfg, jparams, slots=slots, ctx=ctx, seed=0),
            ServeEngine(tcfg, tparams, slots=slots, ctx=ctx, seed=0))


def _port_engine(arch, **kw):
    _, tcfg, _, tparams = _model(arch)
    kw.setdefault("slots", 2)
    kw.setdefault("ctx", 32)
    return ServeEngine(tcfg, tparams, seed=0, **kw)


@pytest.fixture
def f32_logits(monkeypatch):
    monkeypatch.setattr(JL, "unembed", lambda x, w, tied: jnp.einsum(
        "...d,vd->...v" if tied else "...d,dv->...v", x.astype(jnp.float32), w))
    monkeypatch.setattr(L, "unembed", lambda x, w, tied: x.float() @ (
        w.t() if tied else w).float())


class _Report:
    """Scripted PlanReport stand-in (the replanner reads best_impl() and
    best_seconds)."""

    def __init__(self, impl, best_seconds=1e-6):
        self.best_pattern = dict(impl)
        self.best_seconds = best_seconds

    def best_impl(self):
        return Impl(self.best_pattern)


def _recording(detector):
    """Wrap ``detector.observe`` to log the ticks on which it fired."""
    fired: list = []
    inner = detector.observe

    def observe(stats, tick):
        hit = inner(stats, tick)
        if hit:
            fired.append(tick)
        return hit
    detector.observe = observe
    return fired


# ---------------------------------------------------------------------------
# drift -> replan -> canary -> swap, against the JAX engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_drift_replan_swaps_on_the_jax_ticks(arch, f32_logits):
    traffic = ScriptedTraffic(DRIFT_SHORT_TO_LONG, seed=3, vocab=256)
    runs = []
    for eng, (DC, DD, RC, RP) in zip(
            _engines(arch), ((JDriftConfig, JDriftDetector, JReplanConfig,
                              JReplanner),
                             (DriftConfig, DriftDetector, ReplanConfig,
                              Replanner))):
        det = DD(DC(window=4, bucket_l1=0.5, occupancy_delta=2.0,
                    ratio_rel=100.0, hysteresis=2, cooldown=4))
        fired = _recording(det)
        rp = RP(lambda c: _Report(PROBE),
                config=RC(on_drift=True, background=False, window=4),
                detector=det)
        eng.attach_replanner(rp)
        done = drive(eng, traffic)
        st = eng.stats()
        runs.append((fired, list(eng.swap_ticks),
                     {k: st[k] for k in ("swaps", "rollbacks", "degraded",
                                         "plan_generation")},
                     rp.stats()["offers"], rp.stats()["canary_rejects"],
                     streams(done)))
    want, got = runs
    assert got[:5] == want[:5]
    assert got[0] and got[1] and got[2]["swaps"] >= 1
    assert got[5] == want[5]                      # token for token
    twin = _port_engine(arch)
    assert streams(drive(twin, traffic)) == got[5]


# ---------------------------------------------------------------------------
# a NaN generation rolled back with no dropped request
# ---------------------------------------------------------------------------
@pytest.fixture
def nan_mlp():
    """mlp_core=nan in both packages: the port's writes NaN on the device
    while armed (DeviceNaN), the JAX one multiplies its output by NaN."""
    fault = DeviceNaN("mlp_core", base="ref", name="nan")
    fault.arm()
    jregister("mlp_core", "nan")(
        lambda *a, **k: jvariants("mlp_core")["ref"](*a, **k) * jnp.nan)
    try:
        yield fault
    finally:
        fault.close()
        junregister("mlp_core", "nan")


@pytest.mark.parametrize("arch", ARCHS)
def test_nan_generation_rolls_back_with_no_drop(arch, nan_mlp, f32_logits):
    lead = ScriptedTraffic((Phase(ticks=2, per_tick=1, min_len=4, max_len=6,
                                  max_new=8),), seed=3, vocab=256)
    tail = ScriptedTraffic((Phase(ticks=3, per_tick=1, min_len=4, max_len=6,
                                  max_new=6),), seed=5, vocab=256)
    jeng, eng = _engines(arch)
    twin = _port_engine(arch)
    q = Quarantine(threshold=1)
    eng.attach_replanner(Replanner(lambda c: _Report({}),
                                   config=ReplanConfig(background=False),
                                   quarantine=q))
    results = []
    for e in (jeng, eng, twin):
        for prompt, max_new in [r for t in lead.schedule for r in t]:
            e.submit(prompt, max_new_tokens=max_new)
        e.step()
        e.step()
        key = e.plan_key
        if e is not twin:
            e.offer_plan(e.prepare_plan({"mlp_core": "nan"}, warm=False))
        e.step()              # install + fault + rollback within one tick
        check_conservation(e)
        if e is not twin:
            assert e.rollbacks == 1 and e.degraded and e.plan_key == key
            assert "non-finite" in e.last_fault
        results.append((drive(e, tail), e.stats()))
    (jdone, jst), (done, st), (tdone, _) = results
    assert_streams_equal(tdone, done)             # the never-faulted twin
    assert streams(done) == streams(jdone)
    for k in ("swaps", "rollbacks", "degraded", "plan_generation"):
        assert st[k] == jst[k], k
    assert st["rollbacks"] == 1 and st["degraded"]
    assert "non-finite" in st["last_fault"]
    assert q.is_quarantined("mlp_core", "nan")    # reported back
    # a faulted key is refused re-installation
    eng.offer_plan(eng.prepare_plan({"mlp_core": "nan"}, warm=False))
    eng.step()
    assert eng.rollbacks == 1


@pytest.fixture
def flaky_mlp():
    """mlp_core=flaky: the ref variant, raising while ``armed`` is set."""
    armed = threading.Event()

    def flaky(*a, **k):
        if armed.is_set():
            raise RuntimeError("kernel fault at run")
        return variants("mlp_core")["ref"](*a, **k)

    register_variant("mlp_core", "flaky")(flaky)
    try:
        yield armed
    finally:
        unregister_variant("mlp_core", "flaky")


def _lead(e, prompts):
    for p in prompts:
        e.submit(p, max_new_tokens=8)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_run_fault_of_a_built_step_rolls_back(arch, flaky_mlp):
    """A step that was built and raises when it runs again is a run-time
    fault: the generation, re-installed from a fallback with its steps
    built, is rolled back on its first tick (its probation, so the
    recurrent state is restored), leaves the trace memo, and the streams
    equal a twin's that never served it."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 9)]
    eng = _port_engine(arch, impl={"mlp_core": "flaky"})
    twin = _port_engine(arch)
    flaky_key = eng.plan_key
    for e in (eng, twin):
        _lead(e, prompts)
        e.step()                     # the flaky plan's steps are built
    eng.offer_plan(eng.prepare_plan(PROBE, warm=False))
    eng.step()
    twin.step()
    assert flaky_key in eng._trace_memo          # a rollback target
    again = eng.prepare_plan({"mlp_core": "flaky"}, warm=False)
    assert again.decode.step.built               # the memo's built steps
    eng.offer_plan(again)
    flaky_mlp.set()
    eng.step()                       # install, the decode raises, rollback
    twin.step()
    check_conservation(eng)
    assert eng.rollbacks == 1 and eng.degraded
    assert "kernel fault at run" in eng.last_fault
    assert eng.plan_key != flaky_key and flaky_key not in eng._trace_memo
    assert set(eng._trace_memo) == {eng.plan_key}
    done, want = eng.run_to_completion(), twin.run_to_completion()
    assert_streams_equal(want, done)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_decode_fault_after_probation(arch, flaky_mlp):
    """The recurrent-state backup is taken only while the serving
    generation is on probation (until its first finite decode).  After it,
    a decode fault rolls back where the model has no recurrent state, and
    raises PlanFault where it has: that state cannot be restored."""
    rng = np.random.default_rng(12)
    eng = _port_engine(arch, impl={"mlp_core": "flaky"})
    assert eng._probation
    _lead(eng, [rng.integers(0, 256, 6).astype(np.int32)])
    eng.step()
    assert not eng._probation
    flaky_mlp.set()
    if eng._backup:                  # recurrentgemma: RG-LRU state
        with pytest.raises(PlanFault, match="no backup"):
            eng.step()
        assert eng.rollbacks == 0
    else:
        eng.step()
        assert eng.rollbacks == 1 and eng.degraded
        flaky_mlp.clear()
        done = eng.run_to_completion()
        assert len(done) == 1 and len(done[0].generated) == 8


def test_the_trace_memo_keeps_only_live_generations():
    """After each swap the memo holds the serving generation and the
    rollback targets (at most ``_FALLBACK_CAPACITY``), nothing else."""
    eng = _port_engine(ARCHS[1])
    eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=20)
    plans = [{"mlp_core": "offload"}, PROBE, {"mlp_core": "ref"},
             {"replan_probe": "offload", "mlp_core": "offload"}, {},
             {"attn_core": "offload"}, {"attn_core": "offload", **PROBE}]
    for impl in plans:
        eng.prepare_plan({"attn_core": "offload", "mlp_core": "offload",
                          **PROBE}, warm=False)    # prepared, never offered
        eng.offer_plan(eng.prepare_plan(impl, warm=False))
        eng.step()
        live = {eng.plan_key, *(g.key for g in eng._fallbacks)}
        assert set(eng._trace_memo) == live
        assert len(eng._fallbacks) <= _FALLBACK_CAPACITY
    assert eng.swaps == len(plans) and len(eng._fallbacks) == _FALLBACK_CAPACITY
    assert eng.rollbacks == 0


# ---------------------------------------------------------------------------
# the canary rule
# ---------------------------------------------------------------------------
@pytest.fixture
def scaled_mlp():
    register_variant("mlp_core", "scaled")(
        lambda *a, **k: variants("mlp_core")["ref"](*a, **k) * 8.0)
    try:
        yield
    finally:
        unregister_variant("mlp_core", "scaled")


@pytest.mark.parametrize("arch", ARCHS)
def test_canary_rejects_scaled_and_nan_accepts_correct(arch, scaled_mlp):
    eng = _port_engine(arch)
    ok, why = eng.canary_check(eng.prepare_plan(PROBE, warm=False))
    assert ok and "bit-equal" in why            # same decode arithmetic
    # mlp_core=offload differs from ref by rounding: the tolerance path
    ok, why = eng.canary_check(eng.prepare_plan({"mlp_core": "offload"},
                                                warm=False))
    assert ok and "mlp_core" in why and "tol" in why
    ok, why = eng.canary_check(eng.prepare_plan({"mlp_core": "scaled"},
                                                warm=False))
    assert not ok and "tol" in why
    fault = DeviceNaN("mlp_core", base="ref", name="nan")
    try:
        cand = eng.prepare_plan({"mlp_core": "nan"}, warm=False)
        assert eng.canary_check(cand)[0]         # disarmed: it is ref
        fault.arm()
        ok, why = eng.canary_check(cand)
        assert not ok and "non-finite" in why
    finally:
        fault.close()
    assert CANARY_TOL_MIN == 0.05


def test_canary_veto_quarantines_and_is_never_offered_again(scaled_mlp):
    eng = _port_engine(ARCHS[1])
    q = Quarantine(threshold=1)
    rp = Replanner(lambda c: _Report({"mlp_core": "scaled"}),
                   config=ReplanConfig(every_ticks=1, background=False),
                   quarantine=q)
    eng.attach_replanner(rp)
    eng.submit(np.arange(1, 7, dtype=np.int32), max_new_tokens=6)
    eng.run_to_completion()
    assert rp.canary_rejects == 1 and rp.offers == 0
    assert rp.skipped_rejected >= 1 and eng.swaps == 0
    assert q.is_quarantined("mlp_core", "scaled")


# ---------------------------------------------------------------------------
# the background worker: prepare_plan off the tick thread
# ---------------------------------------------------------------------------
def test_background_replan_swaps_between_ticks_streams_unchanged(f32_logits):
    arch = ARCHS[0]
    eng, twin = _port_engine(arch), _port_engine(arch)
    release = threading.Event()

    def plan_fn(conditions):
        release.wait(30)
        return _Report(PROBE)

    rp = Replanner(plan_fn, config=ReplanConfig(every_ticks=3))
    eng.attach_replanner(rp)
    traffic = ScriptedTraffic((Phase(ticks=6, per_tick=1, max_new=8),),
                              seed=9, vocab=256)
    for tick_reqs in traffic.schedule:
        for e in (eng, twin):
            for prompt, max_new in tick_reqs:
                e.submit(prompt, max_new_tokens=max_new)
            e.step()
        if rp._thread is not None:
            release.set()              # the worker builds while we tick
    rp.join(60)
    done, tdone = eng.run_to_completion(), twin.run_to_completion()
    rp.close()
    assert rp.last_error is None and rp.offers >= 1 and eng.swaps >= 1
    assert_streams_equal(tdone, done)


# ---------------------------------------------------------------------------
# regime conditions
# ---------------------------------------------------------------------------
STATS = [{}, {"bucket_hist": {8: 3, 16: 3}, "occupancy_mean": 0.2,
              "decode_prefill_ratio": 0.0},
         {"bucket_hist": {"16": 5, "8": 1}, "occupancy_mean": 0.5,
          "decode_prefill_ratio": 6.5},
         {"bucket_hist": {128: 2}, "occupancy_mean": 0.9,
          "decode_prefill_ratio": 30.0}]


@pytest.mark.parametrize("stats", STATS)
def test_conditions_from_stats_equal_jax(stats):
    assert conditions_from_stats(stats) == jax_conditions(stats)


def test_plan_extra_rekeys_the_plan_not_the_measurements(tmp_path):
    arch = ARCHS[1]
    off = AutoOffloader(PlannerConfig(reps=1, warmup=0))
    cache = PlanCache(tmp_path / "plans.json")
    low = make_lm_program(arch, seq=16, device="cpu",
                          plan_extra={"occupancy_band": "low"})
    high = make_lm_program(arch, seq=16, device="cpu",
                           plan_extra={"occupancy_band": "high"})
    assert plan_cache_key(low, off.config, "cpu") != plan_cache_key(
        high, off.config, "cpu")
    assert measurement_cache_key(low, "cpu") == measurement_cache_key(
        high, "cpu")
    plain = make_lm_program(arch, seq=16, device="cpu")
    assert "plan_conditions" not in str(plain.plan_extra)
    first = off.plan(low, cache=cache)
    assert first.measurements and not first.from_cache
    warm = off.plan(high, cache=cache)
    assert not warm.from_cache and warm.measurements == [] and warm.reused
    # the production plan_fn: conditions become plan_extra, the dominant
    # bucket the measurement seq
    fn = make_replan_fn(arch, off, cache, device="cpu")
    rep = fn({"dominant_bucket": 16, "occupancy_band": "mid",
              "decode_prefill_band": 2})
    assert not rep.from_cache and rep.measurements == []
