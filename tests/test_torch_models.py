"""The port's model layers and model entry points against the JAX package's,
on the same NumPy inputs and on the JAX package's parameters carried over
with ``repro_torch.models.convert``.

Reduced mistral-nemo-12b in float32 (``dataclasses.replace(dtype=...)``):
the point here is the algorithm, so both sides compute in float32 and
differ only in summation order.  Tolerances: 1e-5 for layers, 1e-4 for
logits (two layers of matmuls over d_model 64 and d_ff 128 on top).

Both packages cast the final hidden state to bf16 before the unembedding,
even in float32.  A 1e-6 float32 difference upstream can flip one
element's bf16 rounding there and move every logit by ~4e-4, so the model
tests swap both unembeddings for their float32 product (``f32_logits``);
``test_unembed_keeps_bf16_rounding_of_the_activations`` holds the cast
itself."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import factory as JF
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch.configs.base import get_config
from repro_torch.core.regions import Impl
from repro_torch.models import factory as F
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import tree_map

LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4
ARCH = "mistral-nemo-12b"


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), dtype=dtype),
            dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jparams = JF.init_params(jcfg, jax.random.PRNGKey(0))
    nparams = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_numpy(nparams, "cpu")


@pytest.fixture
def f32_logits(monkeypatch):
    """Both packages' unembeddings without the bf16 cast (see above)."""
    def jax_unembed(x, w, tied):
        return jnp.einsum("...d,dv->...v", x.astype(jnp.float32), w)

    def torch_unembed(x, w, tied):
        return x.float() @ w.float()

    monkeypatch.setattr(JL, "unembed", jax_unembed)
    monkeypatch.setattr(L, "unembed", torch_unembed)


def to_numpy(tree):
    return tree_map(lambda t: t.numpy(), tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _rng(seed=0):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_config_and_templates_mirror_jax():
    jcfg, tcfg = _cfgs("bfloat16")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    full_j, full_t = jax_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(full_j) == dataclasses.asdict(full_t)
    jt = jax.tree.map(lambda s: (s.shape, s.init, s.dtype),
                      JLM.model_template(jcfg),
                      is_leaf=lambda x: hasattr(x, "init"))

    def walk(j, t):
        assert set(j) == set(t)
        for k in j:
            if isinstance(j[k], dict):
                walk(j[k], t[k])
            else:
                assert (j[k][0], j[k][1], j[k][2]) == (t[k].shape, t[k].init,
                                                       t[k].dtype), k
    walk(jt, lm.model_template(tcfg))


def test_layer_kinds_other_than_attention_raise():
    """The SSM and RG-LRU kinds are ported (tests/test_torch_recurrent.py),
    and so are MoE layers (tests/test_torch_moe.py): an MoE config builds,
    its attention layers' FFN routed over the experts.  So do the
    frontends and encoders (tests/test_torch_frontends.py): a patch
    projection, and a cross-attending layer's ``xattn`` weights and ``xkv``
    cache.  Only an unknown kind is refused."""
    base = get_config(ARCH).reduced()
    moe = lm.model_template(dataclasses.replace(base, num_experts=4,
                                                experts_per_token=2))
    assert moe["stack"]["l0"]["ffn"]["w_gate"].shape == (2, 4, 64, 128)
    assert moe["stack"]["l0"]["ffn"]["router"].shape == (2, 64, 4)
    vlm = dataclasses.replace(base, frontend="siglip_stub", frontend_seq=4,
                              frontend_dim=64)
    assert lm.model_template(vlm)["w_front"].shape == (64, 64)
    encdec = dataclasses.replace(base, encoder_layers=2, encoder_seq=8,
                                 cross_attention=True)
    assert "xattn" in lm.model_template(encdec)["stack"]["l0"]
    assert lm.cache_template(encdec, 1, 8)["stack"]["l0"]["xkv"][
        "k"].shape == (2, 1, 2, 8, 16)
    with pytest.raises(ValueError, match="unknown layer kind"):
        lm.model_template(dataclasses.replace(base, layer_pattern=("moe",)))
    assert lm.model_template(dataclasses.replace(base, family="ssm"))


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 16)])
def test_rms_norm(shape):
    rng = _rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    want = JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    _close(L.rms_norm(_t(x), _t(w), 1e-6), want, LAYER_TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_split_halves(theta):
    rng = _rng(2)
    x = rng.standard_normal((2, 4, 7, 16)).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 1, 7)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(L.apply_rope(_t(x), _t(pos), theta), want, LAYER_TOL)


@pytest.mark.parametrize("hq,hkv,s,causal,window,qc,kc", [
    (4, 2, 40, True, 0, 16, 16),       # GQA, ragged chunks
    (4, 4, 33, True, 8, 8, 16),        # sliding window
    (4, 1, 24, False, 0, 512, 1024),   # bidirectional, one chunk
    (8, 2, 70, True, 20, 32, 64),
])
def test_chunked_attention(hq, hkv, s, causal, window, qc, kc):
    rng = _rng(s)
    q = rng.standard_normal((2, hq, s, 16)).astype(np.float32)
    k = rng.standard_normal((2, hkv, s, 16)).astype(np.float32)
    v = rng.standard_normal((2, hkv, s, 16)).astype(np.float32)
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, window=window, q_chunk=qc,
                                k_chunk=kc)
    got = L.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window, q_chunk=qc, k_chunk=kc)
    _close(got, want, LAYER_TOL)


def _decode_inputs(rng, b=3, hq=4, hkv=2, s=24, d=16):
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    sp = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    sp[1, 10:] = -1                                   # empty slots
    sp[2] = (np.arange(s) + 30).astype(np.int32)      # rotated positions
    cur = np.array([s - 1, 9, 50], np.int32)
    return q, k, v, sp, cur


@pytest.mark.parametrize("window", [0, 6])
def test_decode_attention(window):
    q, k, v, sp, cur = _decode_inputs(_rng(3))
    want = JL.decode_attention(*map(jnp.asarray, (q, k, v, sp, cur)),
                               window=window)
    got = L.decode_attention(*map(_t, (q, k, v, sp, cur)), window=window)
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("window", [0, 8])
def test_cache_update_in_place(window):
    rng = _rng(4)
    kc = rng.standard_normal((3, 2, 8, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 2, 8, 16)).astype(np.float32)
    sp = np.full((3, 8), -1, np.int32)
    kn = rng.standard_normal((3, 2, 1, 16)).astype(np.float32)
    vn = rng.standard_normal((3, 2, 1, 16)).astype(np.float32)
    pos = np.array([0, 7, 13], np.int32)          # 13 overflows / rotates
    want = JL.cache_update(*map(jnp.asarray, (kc, vc, sp, kn, vn, pos)),
                           window=window)
    tk, tv, tsp = _t(kc.copy()), _t(vc.copy()), _t(sp.copy())
    got = L.cache_update(tk, tv, tsp, _t(kn), _t(vn), _t(pos), window=window)
    assert got[0] is tk and got[2] is tsp            # written in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unembed_keeps_bf16_rounding_of_the_activations():
    rng = _rng(5)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = rng.standard_normal((64, 256)).astype(np.float32)
    want = JL.unembed(jnp.asarray(x), jnp.asarray(w), False)
    _close(L.unembed(_t(x), _t(w), False), want, LAYER_TOL)


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------
def _tokens(jcfg, b, s, seed=0):
    return _rng(seed).integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("variant", ["ref", "offload", "hopper"])
def test_forward_logits(models, f32_logits, variant):
    jcfg, tcfg, jparams, tparams = models
    toks = _tokens(jcfg, 2, 24)
    want = JLM.forward(jparams, jnp.asarray(toks), cfg=jcfg)
    got = lm.forward(tparams, _t(toks), cfg=tcfg,
                     impl=Impl({"attn_core": variant}))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want, LOGIT_TOL)


@pytest.mark.parametrize("length,ctx", [(None, None), (None, 40), (13, 32),
                                        (1, 16)])
def test_prefill_logits_and_cache(models, f32_logits, length, ctx):
    jcfg, tcfg, jparams, tparams = models
    s = 16 if length is None else {13: 16, 1: 8}[length]
    toks = _tokens(jcfg, 1, s, seed=s)
    jl = None if length is None else jnp.asarray(length, jnp.int32)
    want_logits, want_cache = JLM.prefill(jparams, jnp.asarray(toks),
                                          cfg=jcfg, ctx=ctx, length=jl)
    got_logits, got_cache = lm.prefill(tparams, _t(toks), cfg=tcfg, ctx=ctx,
                                       length=length)
    _close(got_logits, want_logits, LOGIT_TOL)
    jc = jax.tree.map(np.asarray, want_cache)["stack"]["l0"]["attn"]
    tc = to_numpy(got_cache)["stack"]["l0"]["attn"]
    np.testing.assert_array_equal(tc["slot_pos"], jc["slot_pos"])
    _close(tc["k"], jc["k"], LAYER_TOL)
    _close(tc["v"], jc["v"], LAYER_TOL)


def test_decode_steps_follow_the_jax_cache(models, f32_logits):
    jcfg, tcfg, jparams, tparams = models
    toks = _tokens(jcfg, 2, 8, seed=9)
    _, jcache = JLM.prefill(jparams, jnp.asarray(toks), cfg=jcfg, ctx=16)
    tcache = params_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    nxt = np.array([[3], [200]], np.int32)
    for step in range(3):
        pos = np.full((2,), 8 + step, np.int32)
        want, jcache = JLM.decode_step(jparams, jcache, jnp.asarray(nxt),
                                       jnp.asarray(pos), cfg=jcfg)
        got, tcache = lm.decode_step(tparams, tcache, _t(nxt), _t(pos),
                                     cfg=tcfg)
        _close(got, want, LOGIT_TOL)
        nxt = np.asarray(want).argmax(-1).astype(np.int32)
    jc = jax.tree.map(np.asarray, jcache)["stack"]["l0"]["attn"]
    tc = to_numpy(tcache)["stack"]["l0"]["attn"]
    np.testing.assert_array_equal(tc["slot_pos"], jc["slot_pos"])
    _close(tc["k"], jc["k"], LAYER_TOL)


def test_bf16_params_convert_bit_for_bit():
    jcfg, tcfg = _cfgs("bfloat16")
    jparams = JF.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jw = np.asarray(jparams["stack"]["l0"]["attn"]["wq"])
    tw = tparams["stack"]["l0"]["attn"]["wq"]
    assert tw.dtype == torch.bfloat16
    np.testing.assert_array_equal(tw.float().numpy(), jw.astype(np.float32))


def test_init_mirrors_the_jax_scales_including_the_stacked_fan_in():
    cfg = get_config(ARCH).reduced()
    params = F.init_params(cfg, torch.Generator().manual_seed(0))
    attn = params["stack"]["l0"]["attn"]
    # normal: fan_in = shape[-2] = d_model 64 -> std 1/8
    assert abs(float(attn["wq"].float().std()) - 1 / 8) < 0.01
    # scaled: fan_in = shape[0], the layer count (2) -> std 1/sqrt(2)
    assert abs(float(attn["wo"].float().std()) - 2 ** -0.5) < 0.05
    assert float(attn["ln"].abs().max()) == 0.0
    cache = F.init_cache(cfg, 2, 16, "cpu")
    assert int(cache["stack"]["l0"]["attn"]["slot_pos"].max()) == -1


@pytest.mark.parametrize("length", [None, 13])
def test_sliding_window_model_prefill_and_decode(f32_logits, length):
    """A local-attention variant of the reduced config: the rotating
    window cache of prefill (with and without ``length``), of
    ``cache_update`` and of windowed decode attention."""
    jcfg, tcfg = (dataclasses.replace(c, layer_pattern=("local",),
                                      attn_window=8) for c in _cfgs())
    jparams = JF.init_params(jcfg, jax.random.PRNGKey(2))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    toks = _tokens(jcfg, 1, 16, seed=4)
    jl = None if length is None else jnp.asarray(length, jnp.int32)
    want, jcache = JLM.prefill(jparams, jnp.asarray(toks), cfg=jcfg, ctx=32,
                               length=jl)
    got, tcache = lm.prefill(tparams, _t(toks), cfg=tcfg, ctx=32,
                             length=length)
    _close(got, want, LOGIT_TOL)
    nxt = np.asarray(want).argmax(-1).astype(np.int32)
    start = 16 if length is None else length
    for step in range(3):
        pos = np.full((1,), start + step, np.int32)
        want, jcache = JLM.decode_step(jparams, jcache, jnp.asarray(nxt),
                                       jnp.asarray(pos), cfg=jcfg)
        got, tcache = lm.decode_step(tparams, tcache, _t(nxt), _t(pos),
                                     cfg=tcfg)
        _close(got, want, LOGIT_TOL)
        nxt = np.asarray(want).argmax(-1).astype(np.int32)
    jc = jax.tree.map(np.asarray, jcache)["stack"]["l0"]["attn"]
    tc = to_numpy(tcache)["stack"]["l0"]["attn"]
    assert tc["k"].shape[3] == 8              # [L, B, Hkv, window, D], not ctx
    np.testing.assert_array_equal(tc["slot_pos"], jc["slot_pos"])
    _close(tc["k"], jc["k"], LAYER_TOL)
