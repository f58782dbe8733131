"""The port's frontends against the JAX package's: paligemma-3b (a stub of
SigLIP patch embeddings, projected and prepended to the decoder's tokens)
and whisper-small (a conv stem, an encoder and cross-attention), on the
same NumPy inputs and on the JAX parameters carried over by
``repro_torch.models.convert``.

NumPy has no bfloat16: the port's frontend arrays are float32 holding
bf16 values (``factory.bf16_values``) and JAX gets the same values as
bf16, so both models see the same inputs.

Tolerances: the ``mlp_gelu`` and ``conv_stem`` variants 1e-5 in float32
and 2e-2 in bf16 (those of tests/test_kernels.py); the reduced models in
float32 1e-4 (logits, every cache leaf, the encoder's output), with both
unembeddings swapped for their float32 product, as in
tests/test_torch_models.py; the engines' greedy streams token for token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.regions import variants as jax_variants
from repro.models import factory as JF
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models.offload_program import make_lm_program as jax_lm_program
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch.configs.base import get_config
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.planner import AutoOffloader, PlannerConfig
from repro_torch.core.regions import Impl, variants
from repro_torch.models import factory as F
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.offload_program import make_lm_program
from repro_torch.models.params import tree_map
from repro_torch.serving.engine import ServeEngine

ARCHS = ("whisper-small", "paligemma-3b")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOGIT_TOL = 1e-4


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, jax cfg, torch cfg, jax params, torch params): the reduced
    arch in float32 on the JAX draw."""
    jcfg, tcfg = _cfgs(request.param)
    jparams = JF.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return request.param, jcfg, tcfg, jparams, tparams


@pytest.fixture
def f32_logits(monkeypatch):
    """Both packages' unembeddings without the bf16 cast of the hidden
    state (see tests/test_torch_models.py)."""
    def jax_unembed(x, w, tied):
        w = w.T if tied else w
        return jnp.einsum("...d,dv->...v", x.astype(jnp.float32),
                          w.astype(jnp.float32))

    def torch_unembed(x, w, tied):
        return x.float() @ (w.t() if tied else w).float()

    monkeypatch.setattr(JL, "unembed", jax_unembed)
    monkeypatch.setattr(L, "unembed", torch_unembed)


def _batch(cfg, batch=2, seq=12, seed=3):
    """A synthetic batch: tokens and the arch's frontend array."""
    b = F.synthetic_batch(cfg, batch, seq, seed=seed)
    return b["tokens"], b[F.frontend_key(cfg)]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _leaves_with_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _assert_cache_equal(tcache, jcache, tol):
    jleaves = dict(_leaves_with_paths(jax.tree.map(np.asarray, jcache)))
    tleaves = dict(_leaves_with_paths(tcache))
    assert set(jleaves) == set(tleaves)
    for path, want in jleaves.items():
        got = tleaves[path]
        assert tuple(got.shape) == want.shape, path
        _close(got.float().numpy(), want, tol)


# ---------------------------------------------------------------------------
# Configs, parameter counts, templates
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_param_counts_and_templates_equal_jax(arch):
    full_t, full_j = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert dataclasses.asdict(full_t.reduced()) == dataclasses.asdict(
        full_j.reduced())
    assert full_t.param_count() == full_j.param_count()
    lo, hi = {"whisper-small": (2.4e8, 3.5e8),
              "paligemma-3b": (2.4e9, 2.7e9)}[arch]
    assert lo <= full_t.param_count() <= hi
    jt = jax.tree.map(lambda s: (tuple(s.shape), s.init, s.dtype),
                      JLM.model_template(full_j),
                      is_leaf=lambda x: hasattr(x, "init"))
    tt = tree_map(lambda s: (s.shape, s.init, s.dtype),
                  lm.model_template(full_t))
    assert dict(_leaves_with_paths(jt)) == dict(_leaves_with_paths(tt))
    jc = jax.tree.map(lambda s: (tuple(s.shape), s.init, s.dtype),
                      JLM.cache_template(full_j, 4, 512),
                      is_leaf=lambda x: hasattr(x, "init"))
    tc = tree_map(lambda s: (s.shape, s.init, s.dtype),
                  lm.cache_template(full_t, 4, 512))
    assert dict(_leaves_with_paths(jc)) == dict(_leaves_with_paths(tc))


# ---------------------------------------------------------------------------
# The mlp_gelu and conv_stem region variants
# ---------------------------------------------------------------------------
def _normal(rng, shape, scale=1.0):
    return F.bf16_values(rng.standard_normal(shape).astype(np.float32)
                         * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["ref", "offload"])
@pytest.mark.parametrize("shape", [(2, 7, 64, 128), (9, 32, 96)])
def test_mlp_gelu_variants_match_jax(shape, variant, dtype):
    *lead, d, f = shape
    rng = np.random.default_rng(11)
    arrays = (_normal(rng, (*lead, d)), _normal(rng, (d, f), d ** -0.5),
              _normal(rng, (f,), 0.1), _normal(rng, (f, d), f ** -0.5),
              _normal(rng, (d,), 0.1))
    want = jax_variants("mlp_gelu")[variant](
        *(jnp.asarray(a, dtype) for a in arrays))
    got = variants("mlp_gelu")[variant](
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays))
    assert str(got.dtype).removeprefix("torch.") == dtype == str(want.dtype)
    assert tuple(got.shape) == want.shape
    _close(got.float().numpy(), want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["ref", "offload"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("frames", [7, 9, 32])
def test_conv_stem_variants_match_jax(frames, stride, variant, dtype):
    """SAME padding at both strides, odd frame counts included (stride 2
    puts the odd element of the padding on the high side)."""
    rng = np.random.default_rng(frames * 10 + stride)
    cin, cout = 8, 16
    arrays = (_normal(rng, (2, frames, cin)),
              _normal(rng, (3, cin, cout), (3 * cin) ** -0.5),
              _normal(rng, (cout,), 0.1))
    want = jax_variants("conv_stem")[variant](
        *(jnp.asarray(a, dtype) for a in arrays), stride=stride)
    got = variants("conv_stem")[variant](
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays),
        stride=stride)
    assert tuple(got.shape) == want.shape == (2, -(-frames // stride), cout)
    assert str(got.dtype).removeprefix("torch.") == dtype
    _close(got.float().numpy(), want, TOL[dtype])


def test_gelu_is_the_tanh_form():
    x = torch.linspace(-4, 4, 101)
    want = jax.nn.gelu(jnp.asarray(x.numpy()))           # JAX's default
    _close(L.gelu_mlp(x[:, None], torch.ones(1, 1), torch.zeros(1),
                      torch.ones(1, 1), torch.zeros(1))[:, 0].numpy(),
           want, 1e-6)
    erf = torch.nn.functional.gelu(x)
    assert float((erf - torch.from_numpy(np.array(want))).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# The models: encode, forward, prefill, decode
# ---------------------------------------------------------------------------
def test_encode_matches_jax():
    jcfg, tcfg = _cfgs("whisper-small")
    jparams = JF.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    _, frames = _batch(tcfg)
    want = JLM.encode(jparams, jnp.asarray(frames, jnp.bfloat16), cfg=jcfg)
    got = lm.encode(tparams, torch.from_numpy(frames), cfg=tcfg)
    assert tuple(got.shape) == want.shape == (2, tcfg.encoder_seq,
                                               tcfg.d_model)
    _close(got.numpy(), want, LOGIT_TOL)


def test_forward_matches_jax(model, f32_logits):
    arch, jcfg, tcfg, jparams, tparams = model
    tokens, fe = _batch(tcfg)
    want = JLM.forward(jparams, jnp.asarray(tokens), cfg=jcfg,
                       frontend_emb=jnp.asarray(fe, jnp.bfloat16))
    got = F.make_forward(tcfg, Impl())(
        tparams, {"tokens": torch.from_numpy(tokens),
                  F.frontend_key(tcfg): torch.from_numpy(fe)})
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert want.shape == (2, 12, tcfg.vocab_size)      # token positions only
    _close(got.numpy(), want, LOGIT_TOL)


def test_paligemma_serves_without_its_prefix(f32_logits):
    """The patch prefix is optional: without it the decoder runs on the
    tokens alone, as in JAX."""
    jcfg, tcfg = _cfgs("paligemma-3b")
    jparams = JF.init_params(jcfg, jax.random.PRNGKey(2))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tokens, _ = _batch(tcfg)
    want = JLM.forward(jparams, jnp.asarray(tokens), cfg=jcfg)
    _close(lm.forward(tparams, torch.from_numpy(tokens), cfg=tcfg).numpy(),
           want, LOGIT_TOL)


def test_whisper_without_frames_raises():
    _, tcfg = _cfgs("whisper-small")
    params = F.init_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="encoder-decoder"):
        lm.forward(params, torch.zeros(1, 4, dtype=torch.int32), cfg=tcfg)


@pytest.mark.parametrize("length", [None, 9])
def test_prefill_every_cache_leaf_and_decode_match_jax(model, f32_logits,
                                                       length):
    """Prefill (``xkv`` and the prefix's slots included) to a cache of
    ctx 48, right-padded to 12 tokens with ``length``, then two decode
    steps; the caches after each step too."""
    arch, jcfg, tcfg, jparams, tparams = model
    tokens, fe = _batch(tcfg)
    ctx = 48
    jl, jc = JLM.prefill(jparams, jnp.asarray(tokens), cfg=jcfg,
                         frontend_emb=jnp.asarray(fe, jnp.bfloat16), ctx=ctx,
                         length=length)
    batch = {"tokens": torch.from_numpy(tokens),
             F.frontend_key(tcfg): torch.from_numpy(fe)}
    if length is None:
        tl, tc = F.make_prefill_step(tcfg, Impl(), ctx=ctx)(tparams, batch)
    else:
        tl, tc = F.make_bucketed_prefill_step(tcfg, Impl(), ctx=ctx)(
            tparams, batch, length)
    _close(tl.numpy(), jl, LOGIT_TOL)
    _assert_cache_equal(tc, jc, LOGIT_TOL)
    if arch == "whisper-small":
        xkv = tc["stack"]["l0"]["xkv"]["k"]
        assert tuple(xkv.shape) == (tcfg.num_layers, 2, tcfg.num_kv_heads,
                                    tcfg.encoder_seq, tcfg.resolved_head_dim)
        assert float(xkv.abs().max()) > 0
    pos = np.full(2, (length or 12) + tcfg.n_front, np.int32)
    for step in range(2):
        tok = np.asarray([[3 + step], [17 + step]], np.int32)
        jl, jc = JLM.decode_step(jparams, jc, jnp.asarray(tok),
                                 jnp.asarray(pos), cfg=jcfg)
        tl, tc = lm.decode_step(tparams, tc, torch.from_numpy(tok),
                                torch.from_numpy(pos), cfg=tcfg)
        _close(tl.numpy(), jl, LOGIT_TOL)
        _assert_cache_equal(tc, jc, LOGIT_TOL)
        pos = pos + 1


def test_cross_attention_decode_position_stays_int32():
    """The cross-attention decode's "current position" lies past every
    encoder slot and fits int32, as in JAX (2**30)."""
    _, tcfg = _cfgs("whisper-small")
    params = F.init_params(tcfg, torch.Generator().manual_seed(0))
    _, frames = _batch(tcfg, batch=1)
    _, cache = lm.prefill(params, torch.zeros(1, 4, dtype=torch.int32),
                          cfg=tcfg, frontend_emb=torch.from_numpy(frames),
                          ctx=16)
    pos = torch.tensor([4], dtype=torch.int32)
    logits, _ = lm.decode_step(params, cache, torch.ones(1, 1, dtype=torch.int32),
                               pos, cfg=tcfg)
    assert bool(torch.isfinite(logits).all())
    assert torch.full_like(pos, 2**30).dtype == torch.int32


# ---------------------------------------------------------------------------
# The serving engine
# ---------------------------------------------------------------------------
def _requests(cfg, lengths, seed=0):
    out = []
    for i, n in enumerate(lengths):
        tokens, fe = F.synthetic_request(cfg, n, seed=seed + i)
        out.append((tokens, fe))
    return out


def _serve(engine, requests, new_tokens, bf16_frontend=False):
    for tokens, fe in requests:
        engine.submit(tokens, max_new_tokens=new_tokens,
                      frontend=(jnp.asarray(fe, jnp.bfloat16)
                                if bf16_frontend else fe))
    done = engine.run_to_completion()
    return [r.generated for r in done], [r.bucket for r in done]


def test_engine_greedy_streams_equal_the_jax_engine(model, f32_logits):
    """Padded buckets (5 -> 8, 12 -> 16, 7 -> 8) on 2 slots; paligemma's
    16-patch prefix takes 16 of the 48 cache slots."""
    arch, jcfg, tcfg, jparams, tparams = model
    requests = _requests(tcfg, (5, 12, 7))
    want = _serve(JaxEngine(jcfg, jparams, slots=2, ctx=48, seed=0),
                  requests, 6, bf16_frontend=True)
    eng = ServeEngine(tcfg, tparams, slots=2, ctx=48, seed=0)
    got = _serve(eng, requests, 6)
    assert got == want
    assert got[1] == [8, 16, 8]
    st = eng.stats()
    assert st["buckets"] == [8, 16] and st["prefill_traces"] == 2
    assert all(r.frontend is None for r in eng.finished)
    fe_shape = (tcfg.frontend_seq, tcfg.frontend_dim)
    assert eng._prefill_shapes == {(8, fe_shape), (16, fe_shape)}
    # a swapped-in generation is warmed at every (bucket, frontend shape)
    gen = eng.prepare_plan({"attn_core": "offload"})
    assert set(gen.prefill.steps) == {(8, fe_shape), (16, fe_shape)}


def test_paligemma_engine_keys_prefill_by_frontend_shape():
    """A request without its prefix and one with it share a bucket but not
    a prefill step; the prefixed one's tokens go after the 16 patches."""
    _, tcfg = _cfgs("paligemma-3b")
    params = F.init_params(tcfg, torch.Generator().manual_seed(0))
    eng = ServeEngine(tcfg, params, slots=2, ctx=48)
    (tokens, fe), = _requests(tcfg, (6,))
    eng.submit(tokens, max_new_tokens=3)
    eng.submit(tokens, max_new_tokens=3, frontend=fe)
    eng.step()
    assert list(eng.pos) == [6 + 1, 6 + tcfg.n_front + 1]
    eng.run_to_completion()
    assert eng.prefill_traces == 2 and eng.stats()["buckets"] == [8]


def test_submit_rejects_missing_frames_and_overflow():
    for arch in ARCHS:
        _, tcfg = _cfgs(arch)
        params = F.init_params(tcfg, torch.Generator().manual_seed(0))
        eng = ServeEngine(tcfg, params, slots=1, ctx=32)
        (tokens, fe), = _requests(tcfg, (10,))
        if arch == "whisper-small":
            with pytest.raises(ValueError, match="encoder-decoder"):
                eng.submit(tokens, max_new_tokens=4)
        n_front = tcfg.n_front
        # prompt + prefix + new tokens: one past ctx
        with pytest.raises(ValueError, match=f"frontend {n_front}"):
            eng.submit(tokens, max_new_tokens=32 - 10 - n_front + 1,
                       frontend=fe)
        with pytest.raises(ValueError, match="no batch dim"):
            eng.submit(tokens, max_new_tokens=2, frontend=fe[None])
        eng.submit(tokens, max_new_tokens=32 - 10 - n_front, frontend=fe)
    _, dense = _cfgs("mistral-nemo-12b")
    eng = ServeEngine(dense, F.init_params(dense, torch.Generator()),
                      slots=1, ctx=32)
    with pytest.raises(ValueError, match="no frontend"):
        eng.submit(tokens, max_new_tokens=2, frontend=fe)


# ---------------------------------------------------------------------------
# The block-level program and the planner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_program_regions_equal_jax(arch):
    """The port's ``hopper`` stands where JAX's ``pallas`` does."""
    jprog = jax_lm_program(arch)
    tprog = make_lm_program(arch, device="cpu")

    def port_name(variant):
        return "hopper" if variant == "pallas" else variant

    assert [(r.name, r.deploy_variant, r.measure_variant, r.static_kwargs)
            for r in tprog.regions] == [
        (r.name, port_name(r.deploy_variant), port_name(r.measure_variant),
         dict(getattr(r, "static_kwargs", {}) or {})) for r in jprog.regions]
    for tr, jr in zip(tprog.regions, jprog.regions):
        assert [tuple(a.shape) for a in tr.analysis_args] == [
            tuple(a.shape) for a in jr.analysis_args]
    tokens, fe = tprog.sample_inputs(0, torch.device("cpu"))
    out = tprog.build(Impl())(tokens, fe)
    assert tuple(out.shape) == (2, 128, get_config(arch).reduced().vocab_size)


def test_whisper_plans_with_a_finite_baseline_and_hopper_fails(tmp_path):
    """The JAX program cannot run whisper (its build feeds no frames); the
    port's feeds the sample's, so the baseline is finite.  Cross-attention
    has s != sk, which the flash kernel refuses, so a pattern with
    attn_core=hopper is recorded as failed and never selected."""
    prog = make_lm_program("whisper-small", device="cpu")
    cfg = PlannerConfig(strategy="staged", max_measurements=4, reps=1,
                        warmup=0)
    rep = AutoOffloader(cfg).plan(prog, cache=PlanCache(tmp_path / "p.json"))
    assert rep.baseline.ok and np.isfinite(rep.baseline.run_seconds)
    assert {r.name for r in prog.regions} == {"attn_core", "mlp_gelu",
                                               "conv_stem"}
    assert rep.best_impl().get("attn_core") != "hopper"
    hop = [m for m in rep.measurements
           if (m.mapping() or {}).get("attn_core") == "hopper"]
    assert all(not m.ok for m in hop)
    assert any(m.ok for m in rep.measurements)


def test_whisper_prefill_under_hopper_raises_the_wrapper_error():
    _, tcfg = _cfgs("whisper-small", "bfloat16")
    params = F.init_params(tcfg, torch.Generator().manual_seed(0))
    _, frames = _batch(tcfg, batch=1)
    step = F.make_bucketed_prefill_step(tcfg, Impl({"attn_core": "hopper"}),
                                        ctx=16)
    with pytest.raises(ValueError, match="self-attention"):
        step(params, {"tokens": torch.zeros(1, 8, dtype=torch.int32),
                      "frames": torch.from_numpy(frames)}, 5)


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launchers_pass_the_frontend(arch, tmp_path, capsys):
    from repro_torch.launch import serve, serve_throughput
    serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                "--requests", "2", "--new-tokens", "3", "--vary-lengths"])
    out = capsys.readouterr().out
    assert "req 1" in out
    serve_throughput.main(["--arch", arch, "--device", "cpu", "--reduced",
                           "--requests", "3", "--slots", "2"])
    assert "for buckets" in capsys.readouterr().out


def test_every_arch_of_the_jax_zoo_builds():
    """``_check_cfg`` raises for no arch of the JAX registry: every one's
    model and cache templates build at full size (specs only)."""
    from repro.configs import base as JB
    for arch in JB.ARCH_IDS + JB.BONUS_ARCH_IDS:
        cfg = get_config(arch)
        assert lm.model_template(cfg)["embed"].shape == (cfg.vocab_size,
                                                        cfg.d_model)
        assert lm.cache_template(cfg, 1, 64)["stack"]
