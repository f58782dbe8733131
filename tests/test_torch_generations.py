"""The port engine's plan generations against the JAX engine's: prefill
traces per bucket, the trace memo, hot swaps between ticks, the windowed
stats and greedy streams across a swap, on the same NumPy prompts.

On the CPU a generation's steps are the eager step functions (CUDA graphs
are for the card: tests/test_torch_cuda.py), so ``prefill_traces`` counts
first calls per (generation key, bucket) where the JAX engine counts
compilations.  Models are the reduced configs in float32, as
tests/test_replan.py builds them; the JAX parameters are carried over with
``convert.params_from_numpy``.  Greedy streams are compared with both
unembeddings in float32 (the bf16 cast of the hidden state would let a
1e-6 difference swap two near-tied tokens, see tests/test_torch_serving.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from serving_harness import (DRIFT_SHORT_TO_LONG, Phase, ScriptedTraffic,
                             check_conservation, drive)

from repro.configs import get_config as jax_get_config
from repro.models import factory as JF
from repro.models import layers as JL
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch.configs.base import get_config
from repro_torch.kernels import launch_counters
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import serve_throughput
from repro_torch.models import factory as F
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import tree_leaves
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.graphs import StepGraph

ARCHS = ("mistral-nemo-12b", "falcon-mamba-7b", "recurrentgemma-2b")
# what only one engine reports: the port adds the last rollback's cause to
# the JAX engine's rollback telemetry; the timings of the finished-only
# view are not compared
JAX_ONLY: set = set()
PORT_ONLY = {"last_fault"}
TIMINGS = {"ttft_s_mean", "ttft_s_p50", "queue_wait_s_mean",
           "decode_tps_mean"}
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


def _engines(arch: str = ARCHS[0], *, slots: int = 2, ctx: int = 32):
    """(JAX engine, port engine) on the same float32 parameters."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    return (JaxEngine(jcfg, jparams, slots=slots, ctx=ctx, seed=0),
            ServeEngine(tcfg, tparams, slots=slots, ctx=ctx, seed=0))


def _engine() -> ServeEngine:
    _, tcfg, _, tparams = _model(ARCHS[0])
    return ServeEngine(tcfg, tparams, slots=2, ctx=32, seed=0)


@pytest.fixture
def f32_logits(monkeypatch):
    monkeypatch.setattr(JL, "unembed", lambda x, w, tied: jnp.einsum(
        "...d,vd->...v" if tied else "...d,dv->...v", x.astype(jnp.float32), w))
    monkeypatch.setattr(L, "unembed", lambda x, w, tied: x.float() @ (
        w.t() if tied else w).float())


def _untimed(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k not in TIMINGS}


# ---------------------------------------------------------------------------
# prefill traces (tests/test_serving.py::test_prefill_compiles_once_per_bucket)
# ---------------------------------------------------------------------------
def test_prefill_traces_once_per_bucket_like_the_jax_engine():
    rng = np.random.default_rng(100)
    lengths = (5, 6, 7, 9, 12, 15)                  # buckets: 8 and 16
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in lengths]
    for eng in _engines(slots=3, ctx=64):
        for p in prompts:
            eng.submit(p, max_new_tokens=2)
        assert len(eng.run_to_completion()) == len(lengths)
        assert eng.buckets_seen == {8, 16}
        assert eng.prefill_traces == 2              # one per bucket
        # a repeat request in a seen bucket builds nothing new
        eng.submit(np.zeros(10, np.int32), max_new_tokens=2)
        eng.run_to_completion()
        assert eng.prefill_traces == 2
        assert eng.stats()["prefill_traces"] == 2
        assert eng.stats()["buckets"] == [8, 16]


# ---------------------------------------------------------------------------
# windowed / in-flight stats (tests/test_replan.py)
# ---------------------------------------------------------------------------
def test_stats_window_sees_inflight_requests():
    eng = _engine()
    eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=25)
    for _ in range(3):
        eng.step()
    s, w = eng.stats(), eng.stats(window=8)
    # the finished-only aggregate is blind to the long-running request...
    assert s["requests_finished"] == 0 and s["generated_tokens"] == 0
    # ...but both views carry the conserved counters,
    assert s["requests_active"] == 1 and w["requests_active"] == 1
    # and the windowed view sees the admission and the running decode
    assert w["bucket_hist"] == {8: 1}
    assert w["requests_admitted"] == 1
    assert w["decode_tokens"] == 3
    assert w["occupancy_mean"] == pytest.approx(0.5)
    assert w["prompt_len_mean"] == pytest.approx(5.0)
    check_conservation(eng)


def test_stats_window_bounds_and_ratio():
    eng = _engine()
    drive(eng, ScriptedTraffic((Phase(ticks=5, per_tick=1, max_new=4),),
                               seed=1))
    w1, wall = eng.stats(window=1), eng.stats(window=10_000)
    assert w1["ticks_observed"] == 1
    assert wall["ticks_observed"] == eng.ticks
    assert wall["requests_admitted"] == wall["requests_finished_total"] == 5
    assert wall["decode_prefill_ratio"] == pytest.approx(
        wall["decode_tokens"] / 5)


def test_stats_conservation_survives_drain():
    eng = _engine()
    drive(eng, ScriptedTraffic((Phase(ticks=3, per_tick=2),), seed=2))
    assert eng.stats()["requests_finished_total"] == 6
    eng.drain_finished()
    assert eng.stats()["requests_finished"] == 0          # view drained...
    assert eng.stats()["requests_finished_total"] == 6    # ...counter survives
    check_conservation(eng)


def test_windowed_stats_equal_the_jax_engine_key_for_key():
    """One scripted traffic (a drift from bucket 8 to bucket 16) through
    both engines: every windowed view, and the finished-only view less its
    timings, equal key for key; the JAX engine only adds its rollback
    telemetry, and the port its last fault (None: nothing faulted)."""
    jax_eng, eng = _engines(slots=2, ctx=32)
    for e in (jax_eng, eng):
        drive(e, ScriptedTraffic(DRIFT_SHORT_TO_LONG, seed=3, vocab=256))
    for window in (1, 4, 8, 10_000):
        want, got = jax_eng.stats(window=window), eng.stats(window=window)
        assert set(want) - set(got) == JAX_ONLY
        assert set(got) - set(want) == PORT_ONLY
        assert got["last_fault"] is None
        assert ({k: v for k, v in got.items() if k not in PORT_ONLY}
                == {k: want[k] for k in got if k not in PORT_ONLY}), window
    want, got = jax_eng.stats(), eng.stats()
    assert set(want) - set(got) == JAX_ONLY
    got = {k: v for k, v in _untimed(got).items() if k not in PORT_ONLY}
    assert got == {k: want[k] for k in got}
    assert got["prefill_traces"] == 2 and got["buckets"] == [8, 16]


# ---------------------------------------------------------------------------
# hot-swap mechanics (tests/test_replan.py)
# ---------------------------------------------------------------------------
def test_offer_same_key_is_noop_and_trace_memo_reuses():
    eng = _engine()
    eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=4)
    eng.step()
    traces0 = eng.prefill_traces
    same = eng.prepare_plan(None)                 # arch defaults again
    assert same.key == eng.plan_key
    assert same.prefill is eng._gen.prefill       # memo: the same steps
    assert same.decode is eng._gen.decode
    assert traces0 == eng.prefill_traces          # warm reused them
    eng.offer_plan(same)
    eng.step()
    assert eng.swaps == 0 and eng.plan_generation == 0
    # a genuinely different pattern does swap — and swapping BACK reuses
    # the original generation's steps without building any
    eng.offer_plan(eng.prepare_plan(PROBE))
    eng.step()
    assert eng.swaps == 1 and eng.plan_generation == 1
    assert eng.plan_impl["replan_probe"] == "offload"
    traces1 = eng.prefill_traces
    assert traces1 == traces0 + 1                 # the probe's bucket 8
    eng.offer_plan(eng.prepare_plan(None))
    eng.step()
    assert eng.swaps == 2 and eng.prefill_traces == traces1
    assert eng.plan_seconds is None
    eng.run_to_completion()


def test_request_records_admit_tick_and_plan_generation():
    eng = _engine()
    eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3)
    eng.step()
    eng.offer_plan(eng.prepare_plan(PROBE, plan_seconds=1e-3))
    eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3)
    done = eng.run_to_completion()
    assert done[0].admit_tick == 1 and done[0].plan_generation == 0
    assert done[1].plan_generation == 1           # admitted after the swap
    assert eng.swap_ticks == [2]                  # installed before tick 2 ran
    assert eng.plan_seconds == 1e-3


def test_prepare_plan_without_warm_builds_at_first_use():
    eng = _engine()
    eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=2)
    eng.run_to_completion()
    gen = eng.prepare_plan(PROBE, warm=False)
    assert eng.prefill_traces == 1 and gen.prefill.steps == {}
    assert gen.decode.step is None
    eng.offer_plan(gen)
    eng.submit(np.arange(1, 13, dtype=np.int32), max_new_tokens=2)
    eng.run_to_completion()
    assert set(gen.prefill.steps) == {16} and gen.decode.step is not None
    assert eng.prefill_traces == 2


# ---------------------------------------------------------------------------
# greedy streams across a mid-stream swap, every family
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_across_a_swap_equal_the_jax_engine(arch, f32_logits):
    """The same traffic through both engines, each swapping to the probe
    pattern at tick 4 and back at tick 9 while requests are in flight:
    the token streams equal the JAX engine's, token for token, and so do
    the swap counters and each request's admission generation."""
    traffic = ScriptedTraffic((Phase(ticks=4, per_tick=1, max_new=5),
                               Phase(ticks=6, per_tick=1, min_len=9,
                                     max_len=14, max_new=4)),
                              seed=11, vocab=256)
    runs = []
    for eng in _engines(arch, slots=2, ctx=32):
        for tick, reqs in enumerate(traffic.schedule):
            for prompt, max_new in reqs:
                eng.submit(prompt, max_new_tokens=max_new)
            if tick in (4, 9):
                eng.offer_plan(eng.prepare_plan(PROBE if tick == 4 else None))
            eng.step()
        done = eng.run_to_completion()
        runs.append(([r.generated for r in done],
                     [(r.admit_tick, r.plan_generation) for r in done],
                     eng.swaps, eng.swap_ticks, eng.prefill_traces))
    want, got = runs
    assert got == want
    assert got[2] == 2 and got[3] == [5, 10]


# ---------------------------------------------------------------------------
# prefill with a device-tensor length
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", [1, 5, 8])
def test_prefill_tensor_length_equals_int_length(arch, n):
    """A 0-d int32 ``length`` (what one graph per bucket is fed) gives the
    int path's logits and every cache leaf bit for bit."""
    _, tcfg, _, tparams = _model(arch)
    step = F.make_bucketed_prefill_step(tcfg, ctx=16)
    tokens = torch.from_numpy(
        np.random.default_rng(n).integers(0, 256, (1, 8)).astype(np.int32))
    lg_int, cache_int = step(tparams, {"tokens": tokens}, n)
    lg_t, cache_t = step(tparams, {"tokens": tokens},
                         torch.tensor(n, dtype=torch.int32))
    assert torch.equal(lg_int, lg_t)
    for a, b in zip(tree_leaves(cache_int), tree_leaves(cache_t)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# StepGraph on the CPU, the launcher footers
# ---------------------------------------------------------------------------
def test_step_graph_is_the_eager_step_on_the_cpu():
    counters = launch_counters()
    before = [c.launches for c in counters]
    fixed = torch.arange(4.0)

    def fn(w, x, y):
        return w * x + y

    step = StepGraph(fn, (fixed,), {"x": np.ones(4, np.float32),
                                    "y": np.zeros(4, np.float32)})
    assert step.graph is None and step.device == torch.device("cpu")
    got = step(np.full(4, 2.0, np.float32), np.ones(4, np.float32))
    assert torch.equal(got, fixed * 2 + 1)
    assert [c.launches for c in counters] == before


def test_serve_launcher_prints_prefill_first_calls(tmp_path, capsys):
    serve_launcher.main(["--arch", ARCHS[0], "--reduced", "--device", "cpu",
                         "--requests", "4", "--vary-lengths",
                         "--prompt-len", "12", "--new-tokens", "4",
                         "--slots", "2"])
    out = capsys.readouterr().out
    assert "served 4 requests / 16 tokens" in out
    assert "prefill first calls: 2 (buckets [8, 16])" in out


def test_serve_throughput_twin_runs_on_the_cpu(capsys):
    serve_throughput.main(["--device", "cpu", "--reduced", "--slots", "1,2",
                           "--requests", "6", "--new-tokens", "3"])
    out = capsys.readouterr().out.splitlines()
    rows = [ln for ln in out if ln.strip().startswith(("1 |", "2 |"))]
    assert len(rows) == 2, out
    for row in rows:
        assert row.endswith("2 for buckets [8, 16]"), row
