"""The port's recurrent families against the JAX package's: the Mamba-1
block (falcon-mamba-7b) and the RG-LRU / local-attention hybrid
(recurrentgemma-2b), from the blocks up to ``forward``, ``prefill`` (logits
and every cache leaf) and ``decode_step``, on the JAX package's parameters
carried over with ``repro_torch.models.convert``.

Reduced configs in float32, where the two packages differ only in
summation order.  Tolerances: 1e-5 for a block, 1e-4 for logits and
caches (two or three layers on top), as in tests/test_torch_models.py,
whose ``f32_logits`` reasoning holds here too: both unembeddings run
without their bf16 cast of the hidden state, which would let a 1e-6
difference flip one rounding and move every logit by ~4e-4."""
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
from repro.models import rglru as JRG
from repro.models import ssm as JSS
from repro.core.regions import Impl as JImpl
from repro_torch.configs.base import get_config
from repro_torch.core.regions import Impl
from repro_torch.models import factory as F
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SS
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import tree_leaves, tree_map

BLOCK_TOL = 1e-5
LOGIT_TOL = 1e-4
ARCHS = ("falcon-mamba-7b", "recurrentgemma-2b")
SCAN = {"falcon-mamba-7b": ("ssm_scan", ("seq", "ref", "offload", "hopper")),
        "recurrentgemma-2b": ("rglru_scan", ("ref", "offload", "hopper"))}


def _cfgs(arch, dtype="float32", **over):
    return (dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype,
                                **over),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                                **over))


def _models(arch, seed=0, **over):
    jcfg, tcfg = _cfgs(arch, **over)
    jparams = JF.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return (request.param,) + _models(request.param)


@pytest.fixture
def f32_logits(monkeypatch):
    """Both packages' unembeddings without the bf16 cast (see above)."""
    def jax_unembed(x, w, tied):
        return jnp.einsum("...d,vd->...v" if tied else "...d,dv->...v",
                          x.astype(jnp.float32), w)

    def torch_unembed(x, w, tied):
        return x.float() @ (w.t() if tied else w).float()

    monkeypatch.setattr(JL, "unembed", jax_unembed)
    monkeypatch.setattr(L, "unembed", torch_unembed)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=msg)


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _jax_impl(arch, variant):
    """The JAX pattern the port's ``variant`` is held against: its
    namesake, or for ``hopper`` the JAX package's sequential reference
    (the Pallas kernels cannot run here)."""
    region = SCAN[arch][0]
    if variant == "hopper":
        return JImpl({region: "seq"} if region == "ssm_scan" else {})
    return JImpl({region: variant})


def _leaves_with_paths(tree, prefix=""):
    """(path, leaf) pairs sorted by path (JAX rebuilds dicts key-sorted)."""
    if isinstance(tree, dict):
        return sorted(lp for k in tree
                      for lp in _leaves_with_paths(tree[k], f"{prefix}/{k}"))
    return [(prefix, tree)]


def _check_caches(got, want, tol):
    g = _leaves_with_paths(tree_map(lambda t: t.numpy(), got))
    w = _leaves_with_paths(jax.tree.map(np.asarray, want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.shape == b.shape and str(a.dtype) == str(b.dtype), path
        _close(a, b, tol, path)


# ---------------------------------------------------------------------------
# configs, templates, init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_templates_mirror_jax(arch):
    assert (dataclasses.asdict(jax_get_config(arch))
            == dataclasses.asdict(get_config(arch)))
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert (tcfg.d_inner, tcfg.resolved_dt_rank) == (jcfg.d_inner,
                                                     jcfg.resolved_dt_rank)
    for cfg_j, cfg_t in ((jcfg, tcfg), (jax_get_config(arch), get_config(arch))):
        jt = jax.tree.map(lambda s: (s.shape, s.init, s.dtype),
                          JLM.model_template(cfg_j),
                          is_leaf=lambda x: hasattr(x, "init"))
        tt = tree_map(lambda s: (s.shape, s.init, s.dtype),
                      lm.model_template(cfg_t))
        assert _leaves_with_paths(tt) == _leaves_with_paths(
            jax.tree.map(tuple, jt, is_leaf=lambda x: isinstance(x, tuple)))
        jc = jax.tree.map(lambda s: (s.shape, s.dtype),
                          JLM.cache_template(cfg_j, 3, 40),
                          is_leaf=lambda x: hasattr(x, "init"))
        tc = tree_map(lambda s: (s.shape, s.dtype),
                      lm.cache_template(cfg_t, 3, 40))
        assert _leaves_with_paths(tc) == _leaves_with_paths(
            jax.tree.map(tuple, jc, is_leaf=lambda x: isinstance(x, tuple)))


def test_a_log_init_and_float32_leaves_cross_over():
    jcfg, tcfg, jparams, tparams = _models("falcon-mamba-7b")
    mine = F.init_params(dataclasses.replace(tcfg, dtype="bfloat16"),
                         torch.Generator().manual_seed(0))
    want = np.asarray(jparams["stack"]["l0"]["ssm"]["a_log"])
    carried = tparams["stack"]["l0"]["ssm"]["a_log"]
    assert carried.dtype == torch.float32
    np.testing.assert_array_equal(carried.numpy(), want)
    # log(1..N) drawn by each package: torch's and XLA's float32 log differ
    # by at most one ulp (log 7 here)
    drawn = mine["stack"]["l0"]["ssm"]["a_log"]
    assert drawn.dtype == torch.float32
    np.testing.assert_allclose(drawn.numpy(), want, rtol=2e-7, atol=0)
    cache = F.init_cache(get_config("falcon-mamba-7b").reduced(), 2, 8, "cpu")
    assert cache["stack"]["l0"]["ssm"]["h"].dtype == torch.float32
    assert cache["stack"]["l0"]["ssm"]["conv"].dtype == torch.bfloat16
    _, jc = JLM.prefill(jparams, jnp.zeros((1, 4), jnp.int32), cfg=jcfg)
    tc = params_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    assert tc["stack"]["l0"]["ssm"]["h"].dtype == torch.float32


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", SCAN["falcon-mamba-7b"][1])
@pytest.mark.parametrize("length", [None, 9])
def test_mamba_block_matches_jax(variant, length):
    jcfg, tcfg, jparams, tparams = _models("falcon-mamba-7b", seed=1)
    jp = jax.tree.map(lambda t: t[0], jparams["stack"])["l0"]["ssm"]
    tp = tree_map(lambda t: t[0], tparams["stack"])["l0"]["ssm"]
    x = np.random.default_rng(2).standard_normal((2, 13, 64)).astype(
        np.float32)
    jl = None if length is None else jnp.asarray(length, jnp.int32)
    want, wst = JSS.mamba_block(jp, jnp.asarray(x), cfg=jcfg, length=jl,
                                impl=_jax_impl("falcon-mamba-7b", variant))
    got, gst = SS.mamba_block(tp, _t(x), cfg=tcfg, length=length,
                              impl=Impl({"ssm_scan": variant}))
    _close(got, want, BLOCK_TOL)
    _close(gst["conv"], wst["conv"], BLOCK_TOL)
    _close(gst["h"], wst["h"], BLOCK_TOL)


@pytest.mark.parametrize("variant", SCAN["recurrentgemma-2b"][1])
@pytest.mark.parametrize("length", [None, 9])
def test_rglru_block_matches_jax(variant, length):
    jcfg, tcfg, jparams, tparams = _models("recurrentgemma-2b", seed=1)
    jp = jax.tree.map(lambda t: t[0], jparams["stack"])["l0"]["rglru"]
    tp = tree_map(lambda t: t[0], tparams["stack"])["l0"]["rglru"]
    x = np.random.default_rng(3).standard_normal((2, 13, 64)).astype(
        np.float32)
    jl = None if length is None else jnp.asarray(length, jnp.int32)
    want, wst = JRG.rglru_block(jp, jnp.asarray(x), cfg=jcfg, length=jl,
                                impl=_jax_impl("recurrentgemma-2b", variant))
    got, gst = RG.rglru_block(tp, _t(x), cfg=tcfg, length=length,
                              impl=Impl({"rglru_scan": variant}))
    _close(got, want, BLOCK_TOL)
    _close(gst["conv"], wst["conv"], BLOCK_TOL)
    _close(gst["h"], wst["h"], BLOCK_TOL)


def test_recurrent_decode_steps_match_jax():
    rng = np.random.default_rng(4)
    for arch, block, jstep, tstep in (
            ("falcon-mamba-7b", "ssm", JSS.mamba_decode_step,
             SS.mamba_decode_step),
            ("recurrentgemma-2b", "rglru", JRG.rglru_decode_step,
             RG.rglru_decode_step)):
        jcfg, tcfg, jparams, tparams = _models(arch, seed=5)
        jp = jax.tree.map(lambda t: t[0], jparams["stack"])["l0"][block]
        tp = tree_map(lambda t: t[0], tparams["stack"])["l0"][block]
        one = tree_map(lambda s: s.shape,
                       lm.layer_cache_template(tcfg, block, 2, 8))[block]
        state = {k: rng.standard_normal(shape).astype(np.float32)
                 for k, shape in one.items()}
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        want, wst = jstep(jp, jnp.asarray(x),
                          {k: jnp.asarray(v) for k, v in state.items()},
                          cfg=jcfg)
        got, gst = tstep(tp, _t(x), {k: _t(v) for k, v in state.items()},
                         cfg=tcfg)
        _close(got, want, BLOCK_TOL, arch)
        for k in state:
            _close(gst[k], wst[k], BLOCK_TOL, f"{arch} {k}")


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------
def test_forward_logits(models, f32_logits):
    arch, jcfg, tcfg, jparams, tparams = models
    toks = _tokens(jcfg.vocab_size, 2, 24)
    region, names = SCAN[arch]
    for variant in names:
        want = JLM.forward(jparams, jnp.asarray(toks), cfg=jcfg,
                           impl=_jax_impl(arch, variant))
        got = lm.forward(tparams, _t(toks), cfg=tcfg,
                         impl=Impl({region: variant}))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        _close(got, want, LOGIT_TOL, variant)


@pytest.mark.parametrize("length,ctx", [(None, None), (None, 40), (13, 32),
                                        (1, 16)])
def test_prefill_logits_and_every_cache_leaf(models, f32_logits, length, ctx):
    arch, jcfg, tcfg, jparams, tparams = models
    s = 16 if length is None else {13: 16, 1: 8}[length]
    toks = _tokens(jcfg.vocab_size, 1, s, seed=s)
    jl = None if length is None else jnp.asarray(length, jnp.int32)
    want_logits, want_cache = JLM.prefill(jparams, jnp.asarray(toks),
                                          cfg=jcfg, ctx=ctx, length=jl)
    got_logits, got_cache = lm.prefill(tparams, _t(toks), cfg=tcfg, ctx=ctx,
                                       length=length)
    _close(got_logits, want_logits, LOGIT_TOL)
    _check_caches(got_cache, want_cache, LOGIT_TOL)


def test_decode_steps_follow_the_jax_cache(models, f32_logits):
    arch, jcfg, tcfg, jparams, tparams = models
    toks = _tokens(jcfg.vocab_size, 2, 8, seed=9)
    _, jcache = JLM.prefill(jparams, jnp.asarray(toks), cfg=jcfg, ctx=16)
    tcache = params_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    held = tree_leaves(tcache)
    nxt = np.array([[3], [200]], np.int32)
    for step in range(3):
        pos = np.full((2,), 8 + step, np.int32)
        want, jcache = JLM.decode_step(jparams, jcache, jnp.asarray(nxt),
                                       jnp.asarray(pos), cfg=jcfg)
        got, tcache = lm.decode_step(tparams, tcache, _t(nxt), _t(pos),
                                     cfg=tcfg)
        _close(got, want, LOGIT_TOL)
        nxt = np.asarray(want).argmax(-1).astype(np.int32)
    # written in place: the same tensors, holding the JAX cache's values
    assert all(a is b for a, b in zip(tree_leaves(tcache), held))
    _check_caches(tcache, jcache, LOGIT_TOL)


def test_hybrid_tail_layers_prefill_and_decode(f32_logits):
    """Five layers of (RGLRU, RGLRU, LOCAL): one stacked unit and a tail of
    two RG-LRU layers whose params and caches are [B, ...] — the full
    arch's 8 units + 2, cut to size."""
    jcfg, tcfg, jparams, tparams = _models("recurrentgemma-2b", seed=6,
                                           num_layers=5)
    assert lm.layer_plan(tcfg) == (("rglru", "rglru", "local"), 1,
                                   ("rglru", "rglru"))
    toks = _tokens(jcfg.vocab_size, 1, 16, seed=1)
    want, jcache = JLM.prefill(jparams, jnp.asarray(toks), cfg=jcfg, ctx=24,
                               length=jnp.asarray(11, jnp.int32))
    got, tcache = lm.prefill(tparams, _t(toks), cfg=tcfg, ctx=24, length=11)
    _close(got, want, LOGIT_TOL)
    assert tuple(tcache["tail"]["l1"]["rglru"]["h"].shape) == (1, 64)
    _check_caches(tcache, jcache, LOGIT_TOL)
    nxt = np.asarray(want).argmax(-1).astype(np.int32)
    for step in range(2):
        pos = np.full((1,), 11 + step, np.int32)
        want, jcache = JLM.decode_step(jparams, jcache, jnp.asarray(nxt),
                                       jnp.asarray(pos), cfg=jcfg)
        got, tcache = lm.decode_step(tparams, tcache, _t(nxt), _t(pos),
                                     cfg=tcfg)
        _close(got, want, LOGIT_TOL)
        nxt = np.asarray(want).argmax(-1).astype(np.int32)
    _check_caches(tcache, jcache, LOGIT_TOL)


# ---------------------------------------------------------------------------
# bucketed prefill (tests/test_serving.py's exactness checks, on the port)
# ---------------------------------------------------------------------------
def _bucketed_vs_unpadded(tcfg, tparams, n, ctx, impl=None):
    toks = _tokens(tcfg.vocab_size, 1, n, seed=n)
    lg_e, cache_e = lm.prefill(tparams, _t(toks), cfg=tcfg, ctx=ctx, impl=impl)
    padded = np.zeros((1, F.prefill_bucket(n, ctx)), np.int32)
    padded[0, :n] = toks[0]
    lg_b, cache_b = F.make_bucketed_prefill_step(tcfg, impl=impl, ctx=ctx)(
        tparams, {"tokens": _t(padded)}, n)
    # as in the JAX test: 2e-5 (the padded run sums over more masked keys)
    _close(lg_b, lg_e, 2e-5)
    for (path, a), (_, b) in zip(_leaves_with_paths(cache_e),
                                 _leaves_with_paths(cache_b)):
        _close(b, a, 2e-5, f"n={n} {path}")


@pytest.mark.parametrize("arch", ARCHS)
def test_bucketed_prefill_matches_unpadded(arch):
    _, tcfg, _, tparams = _models(arch, seed=7)
    region, names = SCAN[arch]
    for n in (5, 11):
        for variant in names:
            _bucketed_vs_unpadded(tcfg, tparams, n, 32,
                                  Impl({region: variant}))


def test_bucketed_prefill_matches_unpadded_windowed_wraparound():
    """window 8 < prompt 11 < bucket 16: slot j holds the newest valid
    position p = j (mod window) — the rotation branch of the bucketed KV
    gather, with the hopper attention and scan."""
    _, tcfg, _, tparams = _models("recurrentgemma-2b", seed=8, attn_window=8)
    _bucketed_vs_unpadded(tcfg, tparams, 11, 32)
    _bucketed_vs_unpadded(tcfg, tparams, 11, 32,
                          Impl({"rglru_scan": "hopper", "attn_core": "hopper"}))


@pytest.mark.parametrize("arch", ARCHS)
def test_default_impl_matches_jax(arch):
    assert dict(F.default_impl(get_config(arch))) == dict(
        JF.default_impl(jax_get_config(arch)))
