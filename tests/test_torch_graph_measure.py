"""Step 4's graph measurement (``repro_torch.core.search.time_callable``):
on a card each pattern is captured once into a CUDA graph and its replays
are timed.  Here a fake graph with the ``torch.cuda.CUDAGraph`` interface
stands in for it through ``search.graph_type``, so the capture, the
replays, the billing (on a host clock that moves only where a test moves
it), the fault seam, the launch counters and the release are checked on
the CPU.  The ``cuda``-marked tests replay real builds on the card and
hold them bit-equal to eager calls: tdFIR's, and the census of every
single-region pattern of the programs ``chip_smoke.py`` plans.

This file imports neither JAX nor the JAX package (the card's machine has
neither):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_graph_measure.py
"""
import gc
import time
import types
import weakref

import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.apps import decode_attn, mriq
from repro_torch.apps import tdfir as tdfir_app
from repro_torch.configs.paper_apps import TDFIR_FULL, TdFirConfig
from repro_torch.core import cuda_graphs, executor, search
from repro_torch.core.executor import (FaultPolicy, VerificationExecutor,
                                       VerifyJob)
from repro_torch.core.extract import discover
from repro_torch.core.faults import FaultInjector, FaultSpec, wrap_program
from repro_torch.core.planner import AutoOffloader, PlannerConfig
from repro_torch.core.regions import Impl, offload_variants
from repro_torch.kernels import fir
from repro_torch.launch import faults as faults_twin
from repro_torch.launch import loop_extraction, verification
from repro_torch.models.offload_program import make_lm_program

TINY = TdFirConfig(n_banks=4, n_taps=8, n_samples=64)


class Log(list):
    """What happened, in order: "call" (an eager call of the pattern or the
    call under capture), "begin"/"end" (a capture), "replay", "reset"."""

    def __init__(self):
        super().__init__()
        self.graphs: list = []          # weakrefs of every graph made
        self.capturing = False
        self.capture_s = 0.0            # a capture's own cost
        self.now = 0.0                  # the host clock of the `clock` fixture


@pytest.fixture
def log(monkeypatch):
    log = Log()

    class FakeGraph:
        """Stands in for ``torch.cuda.CUDAGraph``: records, computes
        nothing at replay."""

        def __init__(self):
            log.graphs.append(weakref.ref(self))

        def capture_begin(self, pool=None, capture_error_mode="global"):
            assert capture_error_mode == "thread_local" and pool is None
            log.append("begin")
            log.capturing = True
            log.now += log.capture_s

        def capture_end(self):
            log.capturing = False
            log.append("end")

        def replay(self):
            log.append("replay")

        def reset(self):
            log.append("reset")

    monkeypatch.setattr(search, "graph_type", lambda device: FakeGraph)
    return log


def _pattern(log):
    def fn(x):
        log.append("call")
        return x * 2.0
    return fn


X = (torch.ones(8),)


@pytest.mark.parametrize("warmup,reps", [(1, 5), (3, 2), (0, 3)])
def test_one_capture_after_one_eager_call_then_replays(log, warmup, reps):
    m = search.time_callable(_pattern(log), X, warmup=warmup, reps=reps)
    assert m.ok and m.timed_as == "graph"
    # the capture's own replay uploads the graph; then the warm-up and
    # the timed replays
    replays = 1 + max(warmup - 1, 0) + reps
    assert log == (["call", "begin", "call", "end"]
                   + ["replay"] * replays + ["reset"])
    assert len(m.runs) == reps


def test_without_a_graph_type_the_cpu_times_eager_calls():
    calls = []
    m = search.time_callable(lambda x: calls.append(1) or x, X, warmup=2,
                             reps=3)
    assert m.ok and m.timed_as == "eager"
    assert len(calls) == 1 + 1 + 3


@pytest.fixture
def clock(monkeypatch, log):
    """The measuring modules' host clock reads ``log.now``, which only a
    capture moves (by ``log.capture_s``): billing is checked exactly, not
    against the wall of a loaded machine."""
    fake = types.SimpleNamespace(perf_counter=lambda: log.now,
                                 sleep=time.sleep)
    monkeypatch.setattr(search, "time", fake)
    monkeypatch.setattr(executor, "time", fake)
    return fake


def test_the_capture_is_billed_to_compile_seconds(log, clock):
    log.capture_s = 0.05
    art = search.CompiledArtifact(_pattern(log), 1.0)
    m = search.time_callable(None, X, reps=2, precompiled=art)
    assert m.ok
    assert m.compile_seconds == pytest.approx(1.05)
    assert m.compile_wall_s == m.compile_seconds
    # the first call is eager and is not the capture
    assert m.first_run_seconds == 0.0


@pytest.mark.parametrize("workers", [1, 2])
def test_the_executor_bills_the_capture_alike_serial_or_pipelined(
        log, clock, workers):
    # the host compile takes no time on this clock, the capture 0.25 s: in
    # serial mode the pattern is compiled inline, with two workers ahead of
    # the timing thread, and either way the capture is paid on it
    log.capture_s = 0.25
    ex = VerificationExecutor(workers=workers)
    jobs = [VerifyJob(key=(f"p{i}",), build=lambda: _pattern(log), args=X,
                      pattern=f"r=v{i}", impl={"r": f"v{i}"})
            for i in range(3)]
    ms = ex.measure_batch(jobs, reps=2)
    ex.shutdown()
    assert all(m.ok and m.timed_as == "graph" for m in ms)
    assert [m.compile_seconds for m in ms] == pytest.approx([0.25] * 3)
    assert [m.compile_wall_s for m in ms] == pytest.approx([0.25] * 3)
    assert ex.stats.compile_seconds_total == pytest.approx(0.75)
    assert ex.stats.compile_wall_s == pytest.approx(0.75)


def _syncs_under_capture(log):
    def fn(x):
        log.append("call")
        if log.capturing:
            raise RuntimeError("CUDA error: operation not permitted when "
                               "stream is capturing")
        return x + 1.0
    return fn


def test_a_capture_that_raises_is_a_permanent_compile_failure(log):
    art = search.CompiledArtifact(_syncs_under_capture(log), 0.25)
    m = search.time_callable(None, X, reps=3, precompiled=art)
    assert not m.ok
    assert m.failure_phase == "compile" and m.failure_kind == "permanent"
    assert "operation not permitted when stream is capturing" in m.error
    assert m.error.startswith("GraphCapture: RuntimeError")
    assert m.compile_seconds >= 0.25
    # never timed eagerly instead: one eager call, the capture (ended, its
    # own error swallowed for the call's), no replay
    assert log == ["call", "begin", "call", "end"]
    gc.collect()
    assert all(ref() is None for ref in log.graphs)


def test_a_capture_failure_is_not_retried_and_strikes_the_gene(log):
    ex = VerificationExecutor(policy=FaultPolicy(max_retries=2,
                                                 retry_backoff_s=0.0))
    job = VerifyJob(key=("p",), build=lambda: _syncs_under_capture(log),
                    args=X, pattern="r=v", impl={"r": "v"})
    m = ex.measure_one(job, reps=2)
    ex.shutdown()
    assert not m.ok and m.attempts == 1
    q = search.Quarantine(threshold=1)
    assert q.record(m) == ["r=v"]


def _toy_program():
    return tdfir_app.make_program(TINY, TINY, device=torch.device("cpu"))


def test_a_flaky_run_fault_fires_on_the_first_call_once(log):
    inj = FaultInjector(specs=[FaultSpec("flaky", site="run", times=1)])
    prog = wrap_program(_toy_program(), inj)
    impl = Impl({"fir_bank": "offload"})
    policy = FaultPolicy(max_retries=2, retry_backoff_s=0.0)
    ex = VerificationExecutor(policy=policy)
    job = VerifyJob(key=("tdfir", "offload"),
                    build=lambda: prog.build(impl), args=prog.sample_inputs(
                        0, prog.device), pattern=impl.describe(),
                    impl=dict(impl))
    m = ex.measure_one(job, warmup=1, reps=3)
    ex.shutdown()
    assert m.ok and m.attempts == 2 and m.timed_as == "graph"
    assert inj.fired("flaky") == 1
    assert inj.log == [("run", impl.describe(), "flaky")]


@pytest.mark.parametrize("warmup,reps", [(1, 4), (3, 2)])
def test_a_run_fault_of_every_call_fires_at_every_replay(log, warmup, reps):
    inj = FaultInjector(specs=[FaultSpec("slow", site="run", times=0,
                                         delay_s=0.0)])
    prog = wrap_program(_toy_program(), inj)
    fn = prog.build(Impl({"fir_load": "offload"}))
    m = search.time_callable(fn, prog.sample_inputs(0, prog.device),
                             warmup=warmup, reps=reps)
    assert m.ok and m.timed_as == "graph"
    # the first call and every replay but the capture's own (the compile
    # step's); the capture of the inner half none
    assert inj.fired("slow") == 1 + (warmup - 1) + reps
    assert log.count("replay") == 1 + (warmup - 1) + reps


def test_a_nan_run_fault_fails_the_finite_check_at_the_first_call(log):
    inj = FaultInjector(specs=[FaultSpec("nan", site="run", times=0,
                                         transient=False)])
    prog = wrap_program(_toy_program(), inj)
    m = search.time_callable(prog.build(Impl()), prog.sample_inputs(
        0, prog.device), check_finite=True)
    assert not m.ok and m.failure_phase == "run"
    assert m.failure_kind == "permanent" and "NonFinite" in m.error
    assert "begin" not in log          # no capture of a pattern that failed


def _launching(log):
    def fn(x):
        log.append("call")
        fir.fir_filter_bank.launches += 1       # as the wrapper does
        return x * 3.0
    return fn


@pytest.mark.parametrize("warmup,reps", [(1, 5), (2, 3)])
def test_launch_counters_count_every_replay(log, warmup, reps):
    before = fir.fir_filter_bank.launches
    try:
        m = search.time_callable(_launching(log), X, warmup=warmup,
                                 reps=reps)
        assert m.ok
        # the first call and every replay, the capture's uploading one
        # among them; the capture's own line is taken back
        assert (fir.fir_filter_bank.launches - before
                == 1 + 1 + (warmup - 1) + reps)
    finally:
        fir.fir_filter_bank.launches = before


def test_a_replay_on_another_thread_during_a_capture_is_held_not_lost(log):
    before = fir.fir_filter_bank.launches

    def fn(x):
        if log.capturing:
            # what another thread's replay adds meanwhile
            cuda_graphs.add_launches([(fir.fir_filter_bank, 5)])
        return _launching(log)(x)

    try:
        m = search.time_callable(fn, X, warmup=1, reps=2)
        assert m.ok
        assert fir.fir_filter_bank.launches - before == 1 + 5 + 1 + 2
    finally:
        fir.fir_filter_bank.launches = before


def test_the_graph_is_released_when_the_measurement_ends(log):
    m = search.time_callable(_pattern(log), X, reps=3)
    assert m.ok and len(log.graphs) == 1
    assert log[-1] == "reset"
    assert log.graphs[0]() is None      # no reference outlives the call


def test_a_run_failure_releases_the_graph_too(log):
    def fn(x):
        log.append("call")
        return x

    inj = FaultInjector(specs=[FaultSpec("exception", site="run", times=0,
                                         match="")])
    calls = {"n": 0}

    def seam(out):
        calls["n"] += 1
        if calls["n"] > 1:            # the first call passes, a replay fails
            inj.fire("run", "p")
        return out

    def faulty(x):
        return seam(fn(x))

    faulty.inner, faulty.seam = fn, seam
    m = search.time_callable(faulty, X, reps=3)
    assert not m.ok and m.failure_phase == "run"
    assert "InjectedFault" in m.error
    assert log.count("replay") == 2 and log[-1] == "reset"
    assert log.graphs[0]() is None


def test_replays_run_under_the_run_watchdog(log):
    m = search.time_callable(_pattern(log), X, warmup=2, reps=3,
                             run_timeout_s=30.0)
    assert m.ok and log.count("replay") == 1 + 1 + 3


def test_a_plan_times_every_pattern_and_the_baseline_as_graphs(log):
    cfg = PlannerConfig(max_measurements=3, reps=2, warmup=1)
    report = AutoOffloader(cfg).plan(_toy_program())
    assert report.baseline.ok and report.baseline.timed_as == "graph"
    assert report.measurements
    assert all(m.timed_as == "graph" for m in report.measurements if m.ok)
    captures = log.count("begin")
    assert captures == 1 + len(report.measurements)
    assert log.count("reset") == captures
    assert "timed as graph" in report.summary()
    gc.collect()
    assert all(ref() is None for ref in log.graphs)


def test_a_plan_on_the_cpu_says_it_timed_eager_calls():
    cfg = PlannerConfig(max_measurements=2, reps=1, warmup=1)
    report = AutoOffloader(cfg).plan(_toy_program())
    assert report.baseline.timed_as == "eager"
    assert all(m.timed_as == "eager" for m in report.measurements)
    assert "timed as eager" in report.summary()
    assert "timed as graph" not in report.summary()


def test_capture_pattern_captures_the_inner_half(log):
    seen = []

    def inner(x):
        seen.append("inner")
        return x

    def fn(x):
        seen.append("outer")
        return inner(x)

    fn.inner, fn.seam = inner, lambda out: out
    graph = search.capture_pattern(fn, X)
    # captured, then replayed once (the upload)
    assert seen == ["inner"] and log == ["begin", "end", "replay"]
    assert graph.replay() is graph.outputs
    graph.release()
    assert log[-1] == "reset"


# ---------------------------------------------------------------------------
# on the card: real graphs, replayed, against eager calls
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", [{}, {"fir_bank": "hopper"},
                                     {"fir_bank": "hopper",
                                      "fir_energy": "offload",
                                      "fir_load": "offload"}])
def test_tdfir_replays_equal_eager_calls_bit_for_bit(cuda_device, pattern):
    prog = tdfir_app.make_program(TDFIR_FULL, TDFIR_FULL, device=cuda_device)
    args = prog.sample_inputs(0, cuda_device)
    fn = prog.build(Impl(pattern))
    want = [t.clone() for t in fn(*args)]
    graph = search.capture_pattern(fn, args)
    before = fir.fir_filter_bank.launches
    try:
        for _ in range(2):
            assert search.replay_bit_equal(graph, want, args)
        launched = fir.fir_filter_bank.launches - before
        assert launched == (2 if pattern.get("fir_bank") == "hopper" else 0)
    finally:
        graph.release()


@pytest.mark.cuda
def test_step4_on_the_card_times_graph_replays(cuda_device):
    prog = tdfir_app.make_program(TINY, TINY, device=cuda_device)
    m = search.time_callable(prog.build(Impl({"fir_bank": "hopper"})),
                             prog.sample_inputs(0, cuda_device), reps=3)
    assert m.ok and m.timed_as == "graph", m.error


def _discovered(arch, name=None, families=None):
    def make(dev):
        fn, args = loop_extraction.trace_arch(arch, device=dev)
        return discover(fn, args, name=name or arch,
                        **({"families": families} if families else {}))
    return make


# every program chip_smoke.py plans: the paper apps, the decode program,
# the six served archs' LM programs, discover() on the extraction archs
# (and Mistral-NeMo's stitched rmsnorm+mlp_core), the timing twins' own
# programs (autotune plans tdFIR and the decode program)
CENSUS = {
    "tdfir": lambda dev: tdfir_app.make_program(TDFIR_FULL, TDFIR_FULL,
                                                device=dev),
    "mriq": lambda dev: mriq.make_program(device=dev),
    "decode_attn": decode_attn.make_decode_program,
    **{f"lm:{arch}": (lambda dev, arch=arch: make_lm_program(arch,
                                                             device=dev))
       for arch in loop_extraction.ARCHS},
    **{f"discovered:{arch}": _discovered(arch)
       for arch in loop_extraction.ARCHS},
    "discovered:mistral-stitch": _discovered(
        "mistral-nemo-12b", "mistral-stitch",
        ("rmsnorm", "mlp_core", "rmsnorm+mlp_core")),
    "twin:verification": verification.make_program,
    "twin:faults": faults_twin._toy_program,
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CENSUS))
def test_every_single_region_pattern_captures_bit_equal(cuda_device, name):
    """The all-ref pattern and every single-region pattern of every
    registered variant (tile points at their defaults), built by the
    planner's compile step, called once, captured as Step 4 captures it and
    replayed twice, each replay bit-equal to the eager call.  An eager call
    that a kernel refuses for its shape is not a capture fault (whisper's
    cross-attention under ``attn_core=hopper``)."""
    prog = CENSUS[name](cuda_device)
    args = prog.sample_inputs(0, cuda_device)
    impls = [Impl()] + [Impl({r.name: v}) for r in prog.regions
                        for v in offload_variants(r.name)]
    refused, differ = {}, []
    for impl in impls:
        art = search.compile_pattern(lambda impl=impl: prog.build(impl),
                                     search.pattern_sources(impl))
        assert art.ok, f"{impl.describe()}: {art.error}"
        try:
            want = [t.clone() for t in tree_leaves(art.fn(*args))
                    if isinstance(t, torch.Tensor)]
        except ValueError as e:
            refused[impl.describe()] = str(e)
            continue
        graph = search.capture_pattern(art.fn, args)
        try:
            if not all(search.replay_bit_equal(graph, want, args)
                       for _ in range(2)):
                differ.append(impl.describe())
        finally:
            graph.release()
        del want
    print(f"census {name}: {len(impls) - len(refused)} patterns captured, "
          f"{len(differ)} replays differ, refused eagerly: {sorted(refused)}")
    assert not differ, f"replays differ from an eager call: {differ}"
    assert all("does not fit" in e for e in refused.values()), refused
