"""The port's serving engine and sampler: greedy token streams against the
JAX package's ``ServeEngine`` on the same (converted) parameters, slot
isolation, admission control, prefill buckets and the sampling contract.

Reduced mistral-nemo-12b in float32, so greedy streams of the two engines
must be equal token for token.  As in tests/test_torch_models.py, both
unembeddings run without their bf16 cast of the hidden state there, which
would let a 1e-6 float32 difference flip a rounding and move every logit
by ~4e-4 — enough to swap two near-tied tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import factory as JF
from repro.models import layers as JL
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch.configs.base import get_config
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import factory as F
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import (ServeEngine, ServeIncompleteError,
                                        cache_insert)
from repro_torch.serving.sampling import GREEDY, SamplingParams, make_sampler

ARCH = "mistral-nemo-12b"


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    jparams = JF.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _prompts(lengths, vocab=256, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _serve(engine, prompts, new_tokens, sampling=None):
    for p in prompts:
        engine.submit(p, max_new_tokens=new_tokens, sampling=sampling)
    return [r.generated for r in engine.run_to_completion()]


@pytest.fixture
def f32_logits(monkeypatch):
    monkeypatch.setattr(JL, "unembed", lambda x, w, tied: jnp.einsum(
        "...d,dv->...v", x.astype(jnp.float32), w))
    monkeypatch.setattr(L, "unembed", lambda x, w, tied: x.float() @ w.float())


def test_greedy_streams_equal_the_jax_engine(model, f32_logits):
    jcfg, tcfg, jparams, tparams = model
    prompts = _prompts((5, 12, 7))              # buckets 8, 16, 8
    want = _serve(JaxEngine(jcfg, jparams, slots=2, ctx=32, seed=0),
                  prompts, 6)
    got = _serve(ServeEngine(tcfg, tparams, slots=2, ctx=32, seed=0),
                 prompts, 6)
    assert got == want


def test_hopper_variant_serves_the_same_greedy_streams(model, f32_logits):
    _, tcfg, _, tparams = model
    prompts = _prompts((9, 3))
    ref = _serve(ServeEngine(tcfg, tparams, slots=2, ctx=24), prompts, 5)
    hop = _serve(ServeEngine(tcfg, tparams, slots=2, ctx=24,
                             impl={"attn_core": "hopper"}), prompts, 5)
    assert hop == ref


@pytest.mark.parametrize("sampling", [GREEDY,
                                      SamplingParams(temperature=0.9),
                                      SamplingParams(temperature=0.7, top_k=5)])
def test_interleaved_equals_solo(model, sampling):
    _, tcfg, _, tparams = model
    prompts = _prompts((4, 11, 6, 9), seed=1)
    together = _serve(ServeEngine(tcfg, tparams, slots=3, ctx=32, seed=5),
                      prompts, 5, sampling)
    for i, p in enumerate(prompts):
        eng = ServeEngine(tcfg, tparams, slots=3, ctx=32, seed=5)
        eng._next_rid = i                   # the same request id as above
        assert _serve(eng, [p], 5, sampling)[0] == together[i]


def test_submit_admission_control(model):
    _, tcfg, _, tparams = model
    eng = ServeEngine(tcfg, tparams, slots=1, ctx=16)
    with pytest.raises(ValueError, match="ctx=16"):
        eng.submit(np.zeros(10, np.int32), max_new_tokens=7)
    eng.submit(np.zeros(10, np.int32), max_new_tokens=6)     # exactly fits
    with pytest.raises(ValueError):
        eng.submit(np.zeros(0, np.int32))
    with pytest.raises(ValueError):
        eng.submit(np.zeros(3, np.int32), max_new_tokens=0)


def test_stats_conserve_requests_and_incomplete_runs_raise(model):
    _, tcfg, _, tparams = model
    eng = ServeEngine(tcfg, tparams, slots=1, ctx=32)
    for p in _prompts((3, 5, 4)):
        eng.submit(p, max_new_tokens=4)
    with pytest.raises(ServeIncompleteError) as err:
        eng.run_to_completion(max_ticks=2)
    assert err.value.pending and not err.value.finished
    st = eng.stats()
    assert st["requests_submitted"] == (st["requests_finished_total"]
                                        + st["requests_pending"]
                                        + st["requests_active"])
    done = eng.run_to_completion()
    assert [len(r.generated) for r in done] == [4, 4, 4]
    assert eng.stats()["buckets"] == [8]
    assert len(eng.drain_finished()) == 3 and eng.finished == []


def test_cache_insert_writes_the_slot_in_place(model):
    _, tcfg, _, tparams = model
    full = F.init_cache(tcfg, 3, 8, "cpu")
    one = F.init_cache(tcfg, 1, 8, "cpu")
    for t in one["stack"]["l0"]["attn"].values():
        t.fill_(7)
    k = full["stack"]["l0"]["attn"]["k"]
    assert cache_insert(full, one, 1) is full
    assert full["stack"]["l0"]["attn"]["k"] is k
    assert bool((k[:, 1] == 7).all()) and bool((k[:, 0] == 0).all())


@pytest.mark.parametrize("n,cap", [(1, 64), (8, 64), (9, 64), (100, 2080),
                                   (1000, 2080), (2048, 2080), (2060, 2080),
                                   (2080, 2080), (5, 6)])
def test_prefill_bucket_matches_jax(n, cap):
    assert F.prefill_bucket(n, cap) == JF.prefill_bucket(n, cap)


def test_prefill_bucket_rejects_overlong_prompts():
    with pytest.raises(ValueError):
        F.prefill_bucket(65, 64)


def _logits(seed=0, b=3, v=50):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal((b, v)).astype(np.float32))


def test_sampling_is_a_function_of_seed_rid_step_and_row():
    sample = make_sampler(11)
    lg = _logits()
    a = sample(lg, [1, 2, 3], [4, 4, 4], [0.8] * 3, [0] * 3)
    b = sample(lg, [1, 2, 3], [4, 4, 4], [0.8] * 3, [0] * 3)
    np.testing.assert_array_equal(a, b)
    # the same row in another batch position, beside other rows
    c = sample(torch.stack([lg[2], lg[0]]), [3, 1], [4, 4], [0.8, 0.8],
               [0, 0])
    assert list(c) == [a[2], a[0]]
    draws = [int(sample(lg[:1], [1], [s], [5.0], [0])[0]) for s in range(40)]
    assert len(set(draws)) > 1            # the step reseeds the draw
    other = make_sampler(12)              # another engine seed
    assert [int(other(lg[:1], [1], [s], [5.0], [0])[0])
            for s in range(40)] != draws


def test_top_k_one_equals_greedy():
    sample = make_sampler(0)
    lg = _logits(1, b=4)
    greedy = sample(lg, [0, 1, 2, 3], [0] * 4, [0.0] * 4, [0] * 4)
    top1 = sample(lg, [0, 1, 2, 3], [0] * 4, [1.5] * 4, [1] * 4)
    np.testing.assert_array_equal(top1, greedy)
    np.testing.assert_array_equal(greedy, lg.argmax(-1).numpy())


def test_sampling_params_validate():
    with pytest.raises(ValueError):
        SamplingParams(temperature=-1.0)
    with pytest.raises(ValueError):
        SamplingParams(top_k=-2)


def test_serve_launcher_plans_then_hits_the_cache(tmp_path, capsys):
    cache = str(tmp_path / "plans.json")
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--auto-offload",
            "--plan-cache", cache, "--requests", "3", "--vary-lengths",
            "--prompt-len", "12", "--new-tokens", "3", "--slots", "2"]
    serve_launcher.main(argv)
    first = capsys.readouterr().out
    assert "auto-offload [measured search [staged]]" in first
    assert "served 3 requests / 9 tokens" in first
    serve_launcher.main(argv)
    assert "auto-offload [plan cache]" in capsys.readouterr().out


def test_a_kernel_error_propagates_with_no_rollback(model):
    from repro_torch.core.regions import register_variant, unregister_variant
    _, tcfg, _, tparams = model

    def broken(q, k, v, **kw):
        raise RuntimeError("kernel fault")

    register_variant("attn_core", "broken_for_test")(broken)
    try:
        eng = ServeEngine(tcfg, tparams, slots=1, ctx=16,
                          impl={"attn_core": "broken_for_test"})
        eng.submit(np.zeros(4, np.int32), max_new_tokens=2)
        with pytest.raises(RuntimeError, match="kernel fault"):
            eng.run_to_completion()
    finally:
        unregister_variant("attn_core", "broken_for_test")


# ---------------------------------------------------------------------------
# the recurrent families (falcon-mamba-7b, recurrentgemma-2b), reduced, f32
# ---------------------------------------------------------------------------
RECURRENT = {"falcon-mamba-7b": {"ssm_scan": "hopper"},
             "recurrentgemma-2b": {"rglru_scan": "hopper",
                                   "attn_core": "hopper"}}


@pytest.fixture(scope="module", params=sorted(RECURRENT))
def recurrent_model(request):
    arch = request.param
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    jparams = JF.init_params(jcfg, jax.random.PRNGKey(4))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return arch, jcfg, tcfg, jparams, tparams


@pytest.fixture
def f32_logits_tied(monkeypatch):
    """As ``f32_logits``, for tied (recurrentgemma) and untied tables."""
    monkeypatch.setattr(JL, "unembed", lambda x, w, tied: jnp.einsum(
        "...d,vd->...v" if tied else "...d,dv->...v", x.astype(jnp.float32), w))
    monkeypatch.setattr(L, "unembed", lambda x, w, tied: x.float() @ (
        w.t() if tied else w).float())


def test_recurrent_greedy_streams_equal_the_jax_engine(recurrent_model,
                                                       f32_logits_tied):
    """Recurrent state through bucketed prefill, cache_insert into a slot
    and in-place decode: the JAX engine's streams, token for token.  (The
    reduced hybrid's window, 32, outlasts these prompts; the window wraps
    in tests/test_torch_recurrent.py.)"""
    _, jcfg, tcfg, jparams, tparams = recurrent_model
    prompts = _prompts((5, 12, 7, 3))            # buckets 8, 16, 8, 8
    want = _serve(JaxEngine(jcfg, jparams, slots=2, ctx=32, seed=0),
                  prompts, 6)
    got = _serve(ServeEngine(tcfg, tparams, slots=2, ctx=32, seed=0),
                 prompts, 6)
    assert got == want


def test_recurrent_hopper_variants_serve_the_same_greedy_streams(
        recurrent_model, f32_logits_tied):
    arch, _, tcfg, _, tparams = recurrent_model
    prompts = _prompts((9, 3, 14))
    ref = _serve(ServeEngine(tcfg, tparams, slots=2, ctx=24), prompts, 5)
    hop = _serve(ServeEngine(tcfg, tparams, slots=2, ctx=24,
                             impl=RECURRENT[arch]), prompts, 5)
    assert hop == ref


def test_cache_insert_writes_recurrent_state_into_the_slot(recurrent_model):
    arch, _, tcfg, _, _ = recurrent_model
    full = F.init_cache(tcfg, 3, 8, "cpu")
    one = F.init_cache(tcfg, 1, 8, "cpu")
    block = "ssm" if arch == "falcon-mamba-7b" else "rglru"
    for t in one["stack"]["l0"][block].values():
        t.fill_(7)
    h = full["stack"]["l0"][block]["h"]
    assert cache_insert(full, one, 2) is full
    assert full["stack"]["l0"][block]["h"] is h
    for t in full["stack"]["l0"][block].values():
        assert bool((t[:, 2] == 7).all()) and bool((t[:, :2] == 0).all())


@pytest.mark.parametrize("arch", sorted(RECURRENT))
def test_serve_launcher_plans_and_serves_the_recurrent_archs(tmp_path, capsys,
                                                             arch):
    cache = str(tmp_path / "plans.json")
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--auto-offload",
            "--plan-cache", cache, "--requests", "3", "--vary-lengths",
            "--prompt-len", "12", "--new-tokens", "3", "--slots", "2"]
    serve_launcher.main(argv)
    first = capsys.readouterr().out
    assert "auto-offload [measured search [staged]]" in first
    assert "served 3 requests / 9 tokens" in first
    serve_launcher.main(argv)
    assert "auto-offload [plan cache]" in capsys.readouterr().out
