"""The port's Mixture-of-Experts layer (``repro_torch.models.moe``) and the
MoE configs against the JAX package's: the same NumPy inputs through
``moe_dispatch`` (``ref`` dense one-hot, ``offload`` scatter slots) and
``moe_ffn`` (``ref`` token choice, ``offload`` expert choice), the
reduced mixtral-8x7b, arctic-480b (parallel dense residual MLP) and
kimi-k2-1t-a32b from the blocks up to ``forward``, ``prefill`` and
``decode_step`` on the JAX parameters carried over with
``repro_torch.models.convert``, the serving engine's greedy streams, and
``make_lm_program``'s ``moe_dispatch`` region.

Tolerances: float32 1e-5 for a layer (the packages differ in summation
order only), bf16 2e-2 (``tests/test_kernels.py``'s bf16 tolerance), 1e-4
for logits and caches (two layers on top; both unembeddings in float32,
see tests/test_torch_models.py).  The routing decisions themselves (top-k
choices, queue positions, drops) must be the same: a differing choice
moves an output by O(1).

Both packages round the router's input to bf16 before its float32
product, in the float32 models too.  A 1e-7 difference upstream can flip
one such rounding and move a token's gates by ~1e-3 (seen: 3.8e-4 on one
token of reduced kimi-k2's logits), so the float32 model tests run both
routers on the unrounded input (``f32_router``), as the unembeddings run
without their cast; ``test_router_probs_take_float32_products_of_bf16_tokens``
and the layer tests hold the cast itself.
"""
import types
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.regions import Impl as JImpl
from repro.models import factory as JF
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models import moe as JM
from repro.models.offload_program import make_lm_program as jax_lm_program
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch.configs.base import get_config
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.planner import AutoOffloader, PlannerConfig
from repro_torch.core.regions import Impl
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import serve_throughput
from repro_torch.models import factory as F
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import moe as M
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.offload_program import make_lm_program
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.serving.engine import ServeEngine

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOGIT_TOL = 1e-4
ARCHS = ("mixtral-8x7b", "arctic-480b", "kimi-k2-1t-a32b")
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, jnp.bfloat16, torch.bfloat16)}


def _close(got, want, tol, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.float()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=msg)


def _t(a):
    return params_from_numpy(np.asarray(a), "cpu")


def _moe_inputs(t, d=32, e=4, f=48, seed=0, dtype="float32", tied=False):
    """(x, router, w_gate, w_up, w_down) as NumPy arrays of ``dtype``.
    ``tied``: router columns 1 and 2 equal and biased up (every token's
    top two probabilities tie), and tokens repeated in pairs (every
    expert's column of token probabilities ties in pairs)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d))
    wr = rng.standard_normal((d, e)) / np.sqrt(d)
    if tied:
        x[1::2] = x[0::2][: t // 2]
        wr[:, 2] = wr[:, 1]
        x[:, 0] = np.abs(x[:, 0]) + 1.0
        wr[0, 1] = wr[0, 2] = 2.0
    wg = rng.standard_normal((e, d, f)) / np.sqrt(d)
    wu = rng.standard_normal((e, d, f)) / np.sqrt(d)
    wd = rng.standard_normal((e, f, d)) / np.sqrt(f)
    np_dt = DTYPES[dtype][0]
    return tuple(np.asarray(a, np.float32).astype(np_dt)
                 for a in (x, wr, wg, wu, wd))


def _both(args):
    """The NumPy args as JAX arrays and as torch tensors."""
    return [jnp.asarray(a) for a in args], [_t(a) for a in args]


def _params(jargs, targs):
    keys = ("router", "w_gate", "w_up", "w_down")
    return dict(zip(keys, jargs[1:])), dict(zip(keys, targs[1:]))


# ---------------------------------------------------------------------------
# capacity, routing helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 4, 7, 32, 100, 2048, 4096, 12_345])
def test_moe_capacity_matches_jax_over_a_grid(n):
    for e in (4, 8, 128, 384):
        for k in (1, 2, 8):
            for cf in (0.5, 1.0, 1.25, 2.0):
                assert M.moe_capacity(n, e, k, cf) == JM.moe_capacity(
                    n, e, k, cf), (n, e, k, cf)
    assert M.moe_capacity(2048, 8, 2, 1.25) == 640
    assert M.moe_capacity(4096, 8, 2, 1.25) == 1280
    assert M.moe_capacity(4, 8, 2, 1.25) == 8


def test_top_k_breaks_ties_to_the_lower_index_as_jax_does():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, (64, 12)).astype(np.float32)     # many ties
    for k in (1, 2, 5, 12):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = M.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_router_probs_take_float32_products_of_bf16_tokens():
    x, wr = _moe_inputs(16, tied=False)[:2]
    want = JM.router_probs(jnp.asarray(x), jnp.asarray(wr))
    got = M.router_probs(_t(x), _t(wr))
    assert got.dtype == torch.float32
    _close(got, want, 1e-6)
    xb, wb = x.astype(jnp.bfloat16), wr.astype(jnp.bfloat16)
    _close(M.router_probs(_t(xb), _t(wb)),
           JM.router_probs(jnp.asarray(xb), jnp.asarray(wb)), 1e-6)


# ---------------------------------------------------------------------------
# moe_dispatch: ref (dense one-hot) and offload (scatter slots)
# ---------------------------------------------------------------------------
DISPATCH_CASES = {
    # name: (tokens, capacity, tied)
    "room": (32, 40, False),
    "drops": (32, 8, False),          # capacity below demand
    "odd_t": (27, 8, False),          # t not a power of two, drops
    "tied": (32, 16, True),           # tied router columns and tokens
}


@pytest.mark.parametrize("variant,jax_fn", [("ref", JM.moe_dispatch_dense),
                                            ("offload", JM.moe_dispatch_slots)])
@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_dispatch_matches_jax(variant, jax_fn, case, k, dtype):
    t, cap, tied = DISPATCH_CASES[case]
    args = _moe_inputs(t, seed=t + k, dtype=dtype, tied=tied)
    jargs, targs = _both(args)
    kw = {"num_experts": 4, "k": k, "capacity": cap}
    want = jax_fn(*jargs, **kw)
    got = {"ref": M.moe_dispatch_dense,
           "offload": M.moe_dispatch_slots}[variant](*targs, **kw)
    assert got.dtype == DTYPES[dtype][2] and tuple(got.shape) == want.shape
    _close(got, want, TOL[dtype], f"{variant} {case} k={k}")


def test_dispatch_cases_drop_tokens_and_tie_where_they_say():
    """The cases above exercise what they are named for: ``drops`` and
    ``odd_t`` overflow a queue, ``tied`` ties every token's top two (on
    the same two experts, which overflow too)."""
    for case, (t, cap, tied) in DISPATCH_CASES.items():
        x, wr = (_t(a) for a in _moe_inputs(t, seed=t + 2, tied=tied)[:2])
        _, _, _, _, keep = M.route_tokens(x, wr, 4, 2, cap)
        assert bool(keep.all()) == (case == "room"), case
        if tied:
            p = M.router_probs(x, wr)
            assert torch.equal(p[:, 1], p[:, 2])
            assert torch.equal(p[0::2], p[1::2])
            assert bool((p[:, 1] >= p.max(-1).values).all())


def test_dispatch_ref_and_offload_agree_and_drop_to_zero():
    """Both variants are exact token-choice routing: equal to each other,
    and a token dropped by every choice comes out zero."""
    args = _moe_inputs(32, seed=5)
    _, targs = _both(args)
    kw = {"num_experts": 4, "k": 1, "capacity": 8}
    ref = M.moe_dispatch_dense(*targs, **kw)
    off = M.moe_dispatch_slots(*targs, **kw)
    _close(off, ref, TOL["float32"])
    _, _, _, _, keep = M.route_tokens(targs[0], targs[1], 4, 1, 8)
    dropped = ~keep[:, 0]
    assert bool(dropped.any())
    assert bool((ref[dropped] == 0).all())


# ---------------------------------------------------------------------------
# moe_ffn: ref (token choice through moe_dispatch) and offload (expert choice)
# ---------------------------------------------------------------------------
FFN_CASES = {
    # name: (tokens, capacity_factor, group_size, tied)
    "one_group": (32, 1.25, 4096, False),
    "drops": (32, 0.5, 4096, False),       # capacity below demand
    "groups": (64, 1.25, 16, False),       # t > group_size: 4 groups
    "odd_t": (28, 1.25, 8, False),         # t % (t // 8) != 0: 2 groups
    "tied": (48, 1.25, 4096, True),
}


@pytest.mark.parametrize("inner", ["ref", "offload"])
@pytest.mark.parametrize("case", sorted(FFN_CASES))
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_token_choice_matches_jax(inner, case, k, dtype):
    t, cf, _, tied = FFN_CASES[case]
    jargs, targs = _both(_moe_inputs(t, seed=2 * t + k, dtype=dtype,
                                     tied=tied))
    jp, tp = _params(jargs, targs)
    kw = {"num_experts": 4, "k": k, "capacity_factor": cf}
    want = JM.moe_token_onehot(jargs[0], jp, inner_impl=JImpl(
        {"moe_dispatch": inner}), **kw)
    got = M.moe_token_onehot(targs[0], tp, inner_impl=Impl(
        {"moe_dispatch": inner}), **kw)
    _close(got, want, TOL[dtype], f"{case} k={k}")


@pytest.mark.parametrize("case", sorted(FFN_CASES))
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_expert_choice_matches_jax(case, k, dtype):
    t, cf, gs, tied = FFN_CASES[case]
    jargs, targs = _both(_moe_inputs(t, seed=3 * t + k, dtype=dtype,
                                     tied=tied))
    jp, tp = _params(jargs, targs)
    kw = {"num_experts": 4, "k": k, "capacity_factor": cf, "group_size": gs}
    want = JM.moe_expert_choice(jargs[0], jp, **kw)
    got = M.moe_expert_choice(targs[0], tp, **kw)
    assert got.dtype == DTYPES[dtype][2] and tuple(got.shape) == want.shape
    _close(got, want, TOL[dtype], f"{case} k={k}")


def test_expert_choice_group_split_and_fallback():
    """The group count the JAX code takes: t // group_size, lowered until
    it divides t; every expert then picks within its group only."""
    x = torch.zeros(28, 8)
    seen = []
    real_sort = torch.sort

    def spy(probs, *a, **kw):
        seen.append(tuple(probs.shape))
        return real_sort(probs, *a, **kw)

    params = {"router": torch.randn(8, 4), "w_gate": torch.randn(4, 8, 6),
              "w_up": torch.randn(4, 8, 6), "w_down": torch.randn(4, 6, 8)}
    torch.sort = spy
    try:
        M.moe_expert_choice(x, params, num_experts=4, k=2,
                            capacity_factor=1.25, group_size=8)
    finally:
        torch.sort = real_sort
    assert seen == [(2, 4, 14)]             # g = 28 // 8 = 3 -> 2 groups


# ---------------------------------------------------------------------------
# the MoE configs: blocks, forward, prefill, decode
# ---------------------------------------------------------------------------
def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype))


_MODELS: dict = {}


def _model(arch):
    if arch not in _MODELS:
        jcfg, tcfg = _cfgs(arch)
        jparams = JF.init_params(jcfg, jax.random.PRNGKey(5))
        _MODELS[arch] = (jcfg, tcfg, jparams, params_from_numpy(
            jax.tree.map(np.asarray, jparams), "cpu"))
    return _MODELS[arch]


@pytest.fixture
def f32_logits(monkeypatch):
    """Both packages' unembeddings without the bf16 cast (see the module
    docstring of tests/test_torch_models.py)."""
    monkeypatch.setattr(JL, "unembed", lambda x, w, tied: jnp.einsum(
        "...d,dv->...v", x.astype(jnp.float32), w))
    monkeypatch.setattr(L, "unembed", lambda x, w, tied: x.float() @ w.float())


@pytest.fixture
def f32_router(monkeypatch):
    """Both packages' routers on the unrounded float32 input (see the
    module docstring)."""
    names = {n: getattr(jnp, n) for n in dir(jnp) if not n.startswith("__")}
    monkeypatch.setattr(JM, "jnp", types.SimpleNamespace(
        **{**names, "bfloat16": jnp.float32}))
    monkeypatch.setattr(M, "_router_logits", lambda x, w: x.float() @ w.float())


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _leaves_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return sorted(lp for k in tree
                      for lp in _leaves_with_paths(tree[k], f"{prefix}/{k}"))
    return [(prefix, tree)]


def _specs(tree):
    return [(p, s.shape, s.init, s.dtype) for p, s in _leaves_with_paths(tree)]


IMPLS = {"token_choice": ({"moe_ffn": "ref"}, {"moe_ffn": "ref"}),
         "token_choice_slots": ({"moe_ffn": "ref", "moe_dispatch": "offload"},
                                {"moe_ffn": "ref", "moe_dispatch": "offload"}),
         "expert_choice": ({"moe_ffn": "offload"}, {"moe_ffn": "offload"})}


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_templates_and_default_impl_mirror_jax(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jt = JLM.model_template(jcfg)
    want = [(p, tuple(s.shape), s.init, s.dtype) for p, s in
            _leaves_with_paths(jax.tree.map(
                lambda s: s, jt, is_leaf=lambda x: hasattr(x, "init")))]
    assert _specs(lm.model_template(tcfg)) == want
    ffn = lm.model_template(tcfg)["stack"]["l0"]["ffn"]
    e, d = tcfg.num_experts, tcfg.d_model
    f = tcfg.moe_d_ff or tcfg.d_ff
    assert ffn["w_gate"].shape == (tcfg.num_layers, e, d, f)
    assert ffn["w_down"].shape == (tcfg.num_layers, e, f, d)
    assert ffn["router"].shape == (tcfg.num_layers, d, e)
    assert ("dense" in ffn) == bool(tcfg.dense_residual_d_ff)
    assert dict(F.default_impl(get_config(arch))) == dict(
        JF.default_impl(jax_get_config(arch))) == {"moe_ffn": "offload"}


def test_stacked_w_down_takes_the_layer_count_as_fan_in():
    """The JAX init quirk, kept: a stacked ``scaled`` spec draws with std
    1/sqrt(shape[0]), the layer count, for the experts' w_down too."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                              num_layers=4, dtype="float32")
    p = F.init_params(cfg, torch.Generator().manual_seed(0))
    wd = p["stack"]["l0"]["ffn"]["w_down"]
    assert abs(float(wd.std()) - 0.5) < 0.02


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_moe_block_matches_jax(arch, impl, f32_router):
    from repro.models import blocks as JB
    from repro_torch.models import blocks as B
    jcfg, tcfg, jparams, tparams = _model(arch)
    jp = jax.tree.map(lambda a: a[0], jparams["stack"]["l0"]["ffn"])
    tp = tree_map(lambda a: a[0], tparams["stack"]["l0"]["ffn"])
    x = np.random.default_rng(1).standard_normal((2, 12, tcfg.d_model)
                                                 ).astype(np.float32)
    ji, ti = IMPLS[impl]
    want = JB.moe_apply(jp, jnp.asarray(x), cfg=jcfg, impl=JImpl(ji))
    got = B.moe_apply(tp, _t(x), cfg=tcfg, impl=Impl(ti))
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_moe_forward_logits(arch, impl, f32_logits, f32_router):
    jcfg, tcfg, jparams, tparams = _model(arch)
    toks = _tokens(jcfg.vocab_size, 2, 24)
    ji, ti = IMPLS[impl]
    want = JLM.forward(jparams, jnp.asarray(toks), cfg=jcfg, impl=JImpl(ji))
    got = lm.forward(tparams, _t(toks), cfg=tcfg, impl=Impl(ti))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want, LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("length", [None, 13])
def test_moe_prefill_logits_and_every_cache_leaf(arch, length, f32_logits,
                                                 f32_router):
    """Under the default expert choice, the padded bucket's tokens compete
    for the experts too, in both packages (JAX ``lm.prefill``)."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    toks = _tokens(jcfg.vocab_size, 1, 16, seed=4)
    jl = None if length is None else jnp.asarray(length, jnp.int32)
    ji, ti = IMPLS["expert_choice"]
    want_logits, want_cache = JLM.prefill(jparams, jnp.asarray(toks),
                                          cfg=jcfg, ctx=32, length=jl,
                                          impl=JImpl(ji))
    got_logits, got_cache = lm.prefill(tparams, _t(toks), cfg=tcfg, ctx=32,
                                       length=length, impl=Impl(ti))
    _close(got_logits, want_logits, LOGIT_TOL)
    g = _leaves_with_paths(tree_map(lambda t: t.numpy(), got_cache))
    w = _leaves_with_paths(jax.tree.map(np.asarray, want_cache))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.shape == b.shape and str(a.dtype) == str(b.dtype), path
        _close(a, b, LOGIT_TOL, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_steps_follow_the_jax_cache(arch, f32_logits,
                                              f32_router):
    """Decode over 2 slots: expert choice with c = min(8, 2) = 2, so every
    expert takes both tokens (the reference semantics, kept)."""
    jcfg, tcfg, jparams, tparams = _model(arch)
    ji, ti = JImpl(IMPLS["expert_choice"][0]), Impl(IMPLS["expert_choice"][1])
    toks = _tokens(jcfg.vocab_size, 2, 8, seed=9)
    _, jcache = JLM.prefill(jparams, jnp.asarray(toks), cfg=jcfg, ctx=16,
                            impl=ji)
    tcache = params_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    held = tree_leaves(tcache)
    nxt = np.array([[3], [200]], np.int32)
    for step in range(3):
        pos = np.full((2,), 8 + step, np.int32)
        want, jcache = JLM.decode_step(jparams, jcache, jnp.asarray(nxt),
                                       jnp.asarray(pos), cfg=jcfg, impl=ji)
        got, tcache = lm.decode_step(tparams, tcache, _t(nxt), _t(pos),
                                     cfg=tcfg, impl=ti)
        _close(got, want, LOGIT_TOL)
        nxt = np.asarray(want).argmax(-1).astype(np.int32)
    assert all(a is b for a, b in zip(tree_leaves(tcache), held))


def test_bf16_mixtral_forward_matches_jax():
    """The bf16 model as served: routing from float32 logits of bf16
    operands in both packages, so the same experts fire."""
    jcfg, tcfg = _cfgs("mixtral-8x7b", "bfloat16")
    jparams = JF.init_params(jcfg, jax.random.PRNGKey(6))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    toks = _tokens(jcfg.vocab_size, 1, 16, seed=2)
    want = JF.make_forward(jcfg)(jparams, {"tokens": jnp.asarray(toks)})
    got = F.make_forward(tcfg)(tparams, {"tokens": _t(toks)})
    scale = float(np.abs(np.asarray(want)).max())
    _close(np.asarray(got) / scale, np.asarray(want) / scale, TOL["bfloat16"])


# ---------------------------------------------------------------------------
# serving and planning
# ---------------------------------------------------------------------------
def test_mixtral_greedy_streams_equal_the_jax_engine(f32_logits, f32_router):
    """The engines' default pattern (expert choice) with padded buckets:
    every prompt's bucket is longer than the prompt."""
    jcfg, tcfg, jparams, tparams = _model("mixtral-8x7b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 12, 7)]

    def serve(engine):
        for p in prompts:
            engine.submit(p, max_new_tokens=6)
        return [r for r in engine.run_to_completion()]

    want = serve(JaxEngine(jcfg, jparams, slots=2, ctx=32, seed=0))
    got = serve(ServeEngine(tcfg, tparams, slots=2, ctx=32, seed=0))
    assert [r.generated for r in got] == [r.generated for r in want]
    assert [r.bucket for r in got] == [8, 16, 8]


def test_mixtral_lm_program_regions_match_jax():
    jprog = jax_lm_program("mixtral-8x7b")
    tprog = make_lm_program("mixtral-8x7b", device="cpu")
    assert [r.name for r in tprog.regions] == [r.name for r in jprog.regions] \
        == ["attn_core", "moe_dispatch"]
    assert ([r.arg_signature() for r in tprog.regions]
            == [r.arg_signature() for r in jprog.regions])
    moe_t, moe_j = tprog.regions[1], jprog.regions[1]
    assert moe_t.static_kwargs == moe_j.static_kwargs == {
        "num_experts": 8, "k": 2, "capacity": 1280}
    assert moe_t.arg_signature()[2] == "bfloat16[8,4096,14336]"
    assert tprog.source_loop_count == jprog.source_loop_count == 32


def test_cpu_plan_of_the_mixtral_program_completes_then_hits(tmp_path):
    """Step 2 analyses each region with its static kwargs, as Step 3
    lowers it, so ``moe_dispatch``'s ref gets its capacity (the JAX
    planner calls it without them and raises a TypeError)."""
    prog = make_lm_program("mixtral-8x7b", device="cpu")
    cache = PlanCache(tmp_path / "plans.json")
    cfg = PlannerConfig(max_measurements=3, reps=1, warmup=0)
    first = AutoOffloader(cfg).plan(prog, cache=cache)
    assert first.baseline.ok and first.measurements
    moe = next(c for c in first.candidates if c.region == "moe_dispatch")
    # the dense dispatch at 4,096 tokens: its three expert products alone
    # are 3 x 2 x (8 x 1,280) x 4,096 x 14,336 flops
    assert moe.analysis.flops >= 6 * 8 * 1280 * 4096 * 14336
    again = AutoOffloader(cfg).plan(prog, cache=cache)
    assert again.from_cache and not again.measurements


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen2-72b"])
def test_serve_launchers_take_the_new_archs(tmp_path, capsys, arch):
    cache = str(tmp_path / "plans.json")
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--auto-offload",
            "--plan-cache", cache, "--requests", "3", "--vary-lengths",
            "--prompt-len", "12", "--new-tokens", "3", "--slots", "2"]
    serve_launcher.main(argv)
    out = capsys.readouterr().out
    assert "auto-offload [measured search [staged]]" in out
    assert "served 3 requests / 9 tokens" in out
    serve_throughput.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--slots", "2", "--requests", "4"])
    assert "2 for buckets [8, 16]" in capsys.readouterr().out
