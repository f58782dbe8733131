"""The port's verification executor (``core/executor.py``) against the JAX
package's contract: ``verify_workers`` changes when a compile step runs,
never what is measured or selected; the offloader-lifetime CompileCache
builds a pattern once; bounded retry follows the JAX classification; MAD
rejection keeps the same reps; and the kernels' build module builds two
sources together and one source once.

Timings are scripted (a table keyed by pattern) wherever a selection is
compared, so nothing here depends on how fast this machine is.
"""
import sys
import threading

import pytest
import torch

from repro.core import executor as JE
from repro.core import search as JS
from repro_torch.apps import tdfir
from repro_torch.configs.paper_apps import TdFirConfig
from repro_torch.core import executor as TE
from repro_torch.core import search as TS
from repro_torch.core.planner import AutoOffloader, PlannerConfig
from repro_torch.kernels import _build

SMALL = TdFirConfig(4, 16, 256)


def _scripted(pattern: str) -> float:
    if pattern == "all-ref":
        return 1.0
    bonus = 0.3 if "fir_bank=hopper" in pattern else 0.0
    return 0.5 + (sum(ord(c) for c in pattern) % 89) / 500.0 - bonus


@pytest.fixture
def scripted_timing(monkeypatch):
    """time_callable with the real compile step and a scripted run: the
    log records every compile step, in order."""
    log = {"compiles": [], "measured": []}
    real_compile = TS.compile_pattern

    def compile_pattern(build, sources=(), timeout_s=0.0):
        art = real_compile(build, sources, timeout_s)
        log["compiles"].append(art)
        return art

    def time_callable(fn, args, *, pattern="", impl=None, precompiled=None,
                      **kw):
        art = (precompiled if precompiled is not None
               else TS.CompiledArtifact(fn, 0.0))
        if not art.ok:
            return TS.Measurement(pattern, art.compile_seconds, float("inf"),
                                  [], False, art.error, impl=impl,
                                  failure_kind=TS.classify_failure(art.error),
                                  failure_phase="compile")
        s = _scripted(pattern)
        log["measured"].append(pattern)
        return TS.Measurement(pattern, art.compile_seconds, s, [s],
                              impl=dict(impl) if impl is not None else None)

    monkeypatch.setattr(TS, "compile_pattern", compile_pattern)
    monkeypatch.setattr(TS, "time_callable", time_callable)
    return log


@pytest.mark.filterwarnings("ignore:fir_filter_bank")
@pytest.mark.parametrize("strategy", ["staged", "genetic", "surrogate",
                                      "exhaustive"])
def test_same_measured_sequence_and_winner_at_any_worker_count(
        scripted_timing, strategy):
    seen = {}
    for workers in (1, 2, 4):
        cfg = PlannerConfig(strategy=strategy, max_measurements=6, reps=1,
                            warmup=0, verify_workers=workers)
        rep = AutoOffloader(cfg).plan(tdfir.make_program(SMALL, device="cpu"))
        stats = rep.search_trace[-1]
        assert stats["stage"] == "verification executor"
        assert stats["workers"] == workers and rep.verify_workers == workers
        assert f"workers={workers}" in rep.summary()
        seen[workers] = ([m.pattern for m in rep.measurements],
                         rep.best_pattern,
                         [t.get("patterns") for t in rep.search_trace[:-1]])
    assert seen[1] == seen[2] == seen[4]
    assert seen[1][0] and seen[1][1]


@pytest.mark.filterwarnings("ignore:fir_filter_bank")
def test_compile_cache_builds_a_pattern_once_across_two_plans(scripted_timing):
    cfg = PlannerConfig(strategy="exhaustive", max_measurements=8, reps=1,
                        warmup=0, verify_workers=2)
    off = AutoOffloader(cfg)
    r1 = off.plan(tdfir.make_program(SMALL, device="cpu"))
    n_first = len(scripted_timing["compiles"])
    assert n_first >= len(r1.measurements) > 0
    r2 = off.plan(tdfir.make_program(SMALL, device="cpu"))
    assert len(scripted_timing["compiles"]) == n_first   # all warm
    assert r2.best_pattern == r1.best_pattern
    assert r2.search_trace[-1]["compile_cache_hits"] >= len(r2.measurements)
    # a fresh offloader has a cold cache
    AutoOffloader(cfg).plan(tdfir.make_program(SMALL, device="cpu"))
    assert len(scripted_timing["compiles"]) > n_first


def test_compile_key_separates_program_pattern_and_shapes():
    x = torch.zeros(4, 8)
    k = TE.compile_key("p", {"a": "hopper"}, (x,))
    assert k == TE.compile_key("p", {"a": "hopper", "b": "ref"}, (x,))
    assert k != TE.compile_key("q", {"a": "hopper"}, (x,))
    assert k != TE.compile_key("p", {"a": "offload"}, (x,))
    assert k != TE.compile_key("p", {"a": "hopper"}, (torch.zeros(4, 9),))


ERRORS = ["WatchdogTimeout: exceeded 1s", "CompileTimeout: x", "RunTimeout: y",
          "InjectedFault[flaky/transient] at run for p",
          "InjectedFault[exception/permanent] at run for p",
          "RESOURCE_EXHAUSTED: hbm", "DEADLINE_EXCEEDED", "UNAVAILABLE: dev",
          "OutOfMemoryError: boom", "NonFiniteOutput: NaN",
          "TypeError: whatever", "", "CompileTimeout ... /permanent"]


def test_classify_failure_as_the_jax_package():
    for err in ERRORS:
        assert TS.classify_failure(err) == JS.classify_failure(err), err
    # the CUDA allocator's own words are transient too
    assert TS.classify_failure("CUDA out of memory. Tried to") == "transient"


@pytest.mark.parametrize("script,max_retries", [
    (["transient", "ok"], 2), (["transient"] * 5, 2), (["permanent", "ok"], 3),
    (["compile", "transient", "ok"], 3), (["ok"], 0)])
def test_measure_with_retry_as_the_jax_package(script, max_retries):
    def run(pkg):
        S, E = (JS, JE) if pkg == "jax" else (TS, TE)
        calls = [0]

        def once():
            kind = script[min(calls[0], len(script) - 1)]
            calls[0] += 1
            if kind == "ok":
                return S.Measurement("p", 0.5, 1.0, [1.0]), True
            err = {"transient": "RunTimeout: x",
                   "compile": "CompileTimeout: y",
                   "permanent": "TypeError: z"}[kind]
            m = S.Measurement("p", 0.5, float("inf"), [], False, err,
                              failure_kind=S.classify_failure(err),
                              failure_phase="compile" if kind == "compile"
                              else "run")
            return m, kind != "compile"

        m = E.measure_with_retry(once, E.FaultPolicy(
            max_retries=max_retries, retry_backoff_s=0.0))
        return m.ok, m.attempts, m.compile_seconds, calls[0]

    assert run("torch") == run("jax")


@pytest.mark.parametrize("runs", [
    [1.0, 1.01, 0.99, 1.02, 50.0], [1.0, 1.0, 1.0, 9.9],
    [3.0, 2.9, 3.1, 0.1, 3.05, 2.95, 40.0], [5.0, 5.5], [2.0, 2.1, 2.2, 8.0, 9.0]])
@pytest.mark.parametrize("z", [2.0, 3.5])
def test_mad_rejection_keeps_the_jax_reps(runs, z):
    assert TS._mad_reject(list(runs), z) == JS._mad_reject(list(runs), z)


def test_time_callable_mad_rejects_a_slow_rep_and_remeasures():
    calls = [0]

    def fn(x):
        calls[0] += 1
        if calls[0] == 4:                 # the third timed rep
            import time
            time.sleep(0.3)
        return x + 1

    m = TS.time_callable(fn, (torch.ones(4),), warmup=1, reps=5,
                         outlier_mad=3.5, remeasure=2)
    assert m.ok and m.outliers_rejected >= 1 and len(m.runs) >= 6
    assert m.run_seconds < 0.1


# ---------------------------------------------------------------------------
# the build module: different sources build together, one source once
# ---------------------------------------------------------------------------
_STUB = r'''
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
src = sys.argv[-1]
log = os.environ["STUB_NVCC_LOG"]
with open(log, "a") as f:
    f.write(os.path.basename(src) + "\n")
mine = os.path.join(os.path.dirname(log), os.path.basename(src) + ".started")
open(mine, "w").close()
want = [p.strip() for p in os.environ.get("STUB_NVCC_WAIT_FOR", "").split(",") if p.strip()]
others = [os.path.join(os.path.dirname(log), w + ".cu.started")
          for w in want if w + ".cu" != os.path.basename(src)]
deadline = time.time() + 30
while not all(os.path.exists(o) for o in others):
    if time.time() > deadline:
        sys.exit("stub nvcc: the other build never started")
    time.sleep(0.01)
open(out, "wb").close()
'''


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    script = tmp_path / "nvcc_stub.py"
    script.write_text(_STUB)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!/bin/sh\nexec {sys.executable} {script} \"$@\"\n")
    nvcc.chmod(0o755)
    log = tmp_path / "log.txt"
    log.write_text("")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_SOURCE_LOCKS", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setenv("STUB_NVCC_LOG", str(log))
    return log


def _load_all(names):
    errors, libs = [], {}

    def go(i, name):
        try:
            libs[i] = _build.load(name)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=go, args=(i, n))
               for i, n in enumerate(names)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    return errors, libs


def test_two_sources_build_together(stub_nvcc, monkeypatch):
    # each stub build waits until the other has started: a build lock
    # shared by both sources would make the first one wait forever
    monkeypatch.setenv("STUB_NVCC_WAIT_FOR", "fir,mriq")
    errors, libs = _load_all(["fir", "mriq"])
    assert errors == []
    assert sorted(stub_nvcc.read_text().split()) == ["fir.cu", "mriq.cu"]
    assert libs[0][1].endswith(_build.library_path("fir").name)


def test_one_source_is_built_once(stub_nvcc):
    errors, libs = _load_all(["rmsnorm"] * 4)
    assert errors == []
    assert stub_nvcc.read_text().split() == ["rmsnorm.cu"]
    assert len({id(v) for v in libs.values()}) == 1
    _build.load("rmsnorm")                      # loaded: no build
    assert stub_nvcc.read_text().split() == ["rmsnorm.cu"]


def test_a_fresh_build_dir_builds_cold(stub_nvcc, tmp_path, monkeypatch):
    """``REPRO_TORCH_BUILD_DIR`` names where libraries are built and
    loaded from: a fresh directory builds a loaded source again."""
    first = _build.load("fir")
    assert _build.library_path("fir").parent == tmp_path / "build"
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "cold"))
    second = _build.load("fir")
    assert stub_nvcc.read_text().split() == ["fir.cu", "fir.cu"]
    assert second != first and second[1].startswith(str(tmp_path / "cold"))
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR")
    assert _build.build_dir() == _build.BUILD_DIR


def test_compile_step_loads_the_hopper_sources_of_a_pattern(stub_nvcc):
    assert TS.pattern_sources({"fir_bank": "hopper", "fir_load": "offload",
                               "rmsnorm+mlp_core": "hopper",
                               "compute_q": ("hopper", {"x": 1})}) == (
        "fir", "mriq", "rmsnorm")
    art = TS.compile_pattern(lambda: "built", ("fir", "mriq"))
    assert art.ok and art.fn == "built" and art.compile_seconds >= 0
    assert sorted(stub_nvcc.read_text().split()) == ["fir.cu", "mriq.cu"]
    bad = TS.compile_pattern(lambda: 1 / 0)
    assert not bad.ok and "ZeroDivisionError" in bad.error


def test_plan_key_takes_the_jax_fields():
    """verify_workers keys pipelined plans apart (serial, the default, adds
    nothing: pre-executor keys stay); seed and the GA knobs key only the
    strategies that read them; the fault-tolerance knobs key nothing."""
    from repro_torch.core.plan_cache import plan_cache_key
    prog = tdfir.make_program(SMALL, device="cpu")

    def key(**kw):
        return plan_cache_key(prog, PlannerConfig(**kw), "cpu")

    assert key() == key(verify_workers=1) != key(verify_workers=4)
    assert key(strategy="staged", seed=3, ga_mutation=0.5) == key()
    assert key(strategy="genetic", seed=1) != key(strategy="genetic", seed=2)
    assert key(strategy="surrogate", ga_topk=3) != key(strategy="surrogate")
    assert key(strategy="auto", seed=1) != key(strategy="auto", seed=2)
    assert key(compile_timeout_s=5.0, run_timeout_s=9.0, max_retries=7,
               retry_backoff_s=0.0, outlier_mad=0.0, remeasure=0,
               quarantine_threshold=5, reps=9, warmup=3) == key()


def test_ledger_is_exact_under_concurrent_measurement():
    """16 threads ask for 8 patterns (each twice over) with a budget of 6:
    every measured pattern is measured once, the budget is spent exactly,
    and every asker gets a measurement or None (budget gone)."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        calls: dict = {}
        lock = threading.Lock()

        def measure_fn(impl):
            key = TS.impl_key(impl)
            with lock:
                calls[key] = calls.get(key, 0) + 1
            return TS.Measurement(str(key), 0.0, 1.0, [1.0], impl=dict(impl))

        led = TS.MeasurementLedger(measure_fn, budget=6)
        impls = [{f"r{i}": "offload"} for i in range(8)] * 2
        results: list = []

        def ask(impl):
            results.append(led.measure(impl))

        threads = [threading.Thread(target=ask, args=(i,)) for i in impls]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert all(n == 1 for n in calls.values()) and len(calls) == 6
        assert led.budget == 0 and led.misses == 6 and len(led.order) == 6
        assert sum(r is not None for r in results) >= 6
        assert not led._inflight
    finally:
        sys.setswitchinterval(old)
