"""The port's int8 weight-only quantization (``repro_torch.optim.quantize``)
and its quantized serve step against the JAX package's.

Leaf for leaf on the same NumPy weights: the int8 values equal and the
scales within 1e-7 relative (one max and one division by 127 in float32
on both sides), stacked leaves included, whose scale is the max over every
axis but the last, so all layers share it.  The decode step over the
quantized tree, which the port dequantizes where each weight is used (a
stacked leaf one layer at a time), against JAX's, which dequantizes the
whole tree at the top of the step: logits within 1e-4 in float32 (the
tolerance of tests/test_torch_models.py, both unembeddings without their
bf16 cast for the reason given there), and within the check of
tests/test_quantize.py against the unquantized step.
"""
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
from repro.optim import quantize as JQ
from repro_torch.configs.base import get_config
from repro_torch.models import factory as F
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import quantize as Q

SCALE_TOL = 1e-7
LOGIT_TOL = 1e-4


def _leaf_pair(shape, dtype, seed):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w *= np.linspace(0.1, 3.0, shape[-1], dtype=np.float32)   # per-channel
    jw = jnp.asarray(w).astype(jnp.dtype(dtype))
    return jw, params_from_numpy(np.asarray(jw), "cpu")


@pytest.mark.parametrize("shape", [(16, 8), (3, 16, 8), (2, 4, 16, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_leaf_matches_jax(shape, dtype):
    jw, tw = _leaf_pair(shape, dtype, seed=len(shape))
    want, got = JQ.quantize_leaf(jw), Q.quantize_leaf(tw)
    assert got["q"].dtype == torch.int8 and got["q"].shape == shape
    assert got["scale"].dtype == torch.float32
    assert tuple(got["scale"].shape) == (shape[-1],)    # shared by layers
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_allclose(got["scale"].numpy(), np.asarray(want["scale"]),
                               rtol=SCALE_TOL, atol=0)
    back = Q.dequantize_leaf(got, torch.float32)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(JQ.dequantize_leaf(want, jnp.float32)),
        rtol=SCALE_TOL, atol=0)
    # rounded to bf16 once, from the float32 product, as JAX's convert
    bf = Q.dequantize_leaf(got, torch.bfloat16)
    assert torch.equal(bf, (got["q"].float() * got["scale"]).to(torch.bfloat16))
    np.testing.assert_array_equal(
        bf.view(torch.int16).numpy(),
        np.asarray(JQ.dequantize_leaf(want, jnp.bfloat16)).view(np.int16))


@pytest.mark.parametrize("rows,cols", [(2, 1), (7, 5), (32, 32), (5, 31)])
def test_quantize_roundtrip_error_bound(rows, cols):
    w = torch.from_numpy(np.random.default_rng(rows * 131 + cols)
                         .standard_normal((rows, cols)).astype(np.float32))
    qd = Q.quantize_leaf(w)
    err = (Q.dequantize_leaf(qd, torch.float32) - w).abs()
    assert bool((err <= qd["scale"][None, :] * 0.5 + 1e-6).all())


def _reduced(arch, dtype="float32"):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    jparams = JF.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "recurrentgemma-2b"])
def test_quantize_params_matches_jax_leaf_for_leaf(arch):
    """bf16 trees: which leaves quantize, their int8 values and scales, and
    the dequantized tree."""
    _, _, jparams, tparams = _reduced(arch, "bfloat16")
    want = _flat(jax.tree.map(np.asarray, JQ.quantize_params(jparams)))
    got = _flat(Q.quantize_params(tparams))
    assert got.keys() == want.keys()
    assert any(k.endswith("/q") for k in got)
    for k, w in want.items():
        g = got[k]
        if k.endswith("/scale"):
            np.testing.assert_allclose(g.numpy(), w, rtol=SCALE_TOL, atol=0)
        elif w.dtype.name == "bfloat16":
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16), err_msg=k)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
    jback = _flat(jax.tree.map(np.asarray, JQ.dequantize_params(
        JQ.quantize_params(jparams))))
    tback = _flat(Q.dequantize_params(Q.quantize_params(tparams)))
    for k, w in jback.items():
        np.testing.assert_allclose(tback[k].float().numpy(),
                                   np.asarray(w, np.float32), rtol=1e-2,
                                   atol=0, err_msg=k)


@pytest.mark.parametrize("arch", ["qwen2-72b", "mixtral-8x7b",
                                  "mistral-nemo-12b", "whisper-small"])
def test_quantized_template_and_bytes_match_jax(arch):
    tmpl, jtmpl = lm.model_template(get_config(arch)), JLM.model_template(
        jax_get_config(arch))
    assert Q.quantized_bytes(tmpl) == JQ.quantized_bytes(jtmpl)
    want = _flat(jax.tree.map(lambda s: (s.shape, s.axes, s.init, s.dtype),
                              JQ.quantized_template(jtmpl),
                              is_leaf=lambda x: hasattr(x, "axes")))
    got = _flat(tree_map(lambda s: (s.shape, s.axes, s.init, s.dtype),
                         Q.quantized_template(tmpl)))
    assert got == want
    if arch == "qwen2-72b":
        orig, quant = Q.quantized_bytes(tmpl)
        assert 1.9 < orig / quant <= 2.01


def test_init_quantized_equals_quantizing_the_drawn_tree():
    """Drawn layer slice by layer slice twice (the max first), the
    quantized tree equals quantize_params of the whole draw."""
    cfg = get_config("mixtral-8x7b").reduced()
    tmpl = lm.model_template(cfg)
    want = Q.quantize_params(F.init_params(cfg, torch.Generator()
                                           .manual_seed(3)))
    got = Q.init_quantized(tmpl, torch.Generator().manual_seed(3))
    flat_w, flat_g = _flat(want), _flat(got)
    assert flat_w.keys() == flat_g.keys()
    for k in flat_w:
        assert torch.equal(flat_g[k], flat_w[k]), k


def test_layer_slices_of_an_unquantized_tree_are_views():
    """The unquantized path gains no operation: a layer's leaves are views
    of the stacked leaves, as before; a quantized stacked leaf becomes a
    dequantized copy of that layer only."""
    cfg = get_config("mixtral-8x7b").reduced()
    params = F.init_params(cfg, torch.Generator().manual_seed(0))
    layer = lm._layer(params["stack"], 1, torch.bfloat16)
    for got, full in zip(tree_leaves(layer), tree_leaves(params["stack"])):
        assert got.data_ptr() == full[1].data_ptr() and got.shape == full[1].shape
    qstack = Q.quantize_params(params)["stack"]
    qlayer = lm._layer(qstack, 1, torch.bfloat16)
    w = qstack["l0"]["ffn"]["w_gate"]
    assert torch.equal(qlayer["l0"]["ffn"]["w_gate"], Q.dequantize_leaf(
        {"q": w["q"][1], "scale": w["scale"]}, torch.bfloat16))


@pytest.fixture
def f32_logits(monkeypatch):
    def jax_unembed(x, w, tied):
        return jnp.einsum("...d,vd->...v" if tied else "...d,dv->...v",
                          x.astype(jnp.float32), w)

    def torch_unembed(x, w, tied):
        return x.float() @ (w.t() if tied else w).float()

    monkeypatch.setattr(JL, "unembed", jax_unembed)
    monkeypatch.setattr(L, "unembed", torch_unembed)


@pytest.mark.parametrize("arch", ["qwen2-72b", "mixtral-8x7b",
                                  "recurrentgemma-2b"])
def test_quantized_serve_step_matches_jax(arch, f32_logits):
    """At-use dequantization against JAX's top-of-step dequantization on
    the same quantized weights and cache; and the quantized step against
    the unquantized one (tests/test_quantize.py's check)."""
    jcfg, tcfg, jparams, tparams = _reduced(arch)
    s = 12
    tokens = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, s),
                                               dtype=np.int32)
    _, jcache = JF.make_prefill_step(jcfg, ctx=16)(
        jparams, {"tokens": jnp.asarray(tokens)})
    tok, pos = tokens[:, -1:], np.full((2,), s, np.int32)
    jq = JQ.quantize_params(jparams)
    want, _ = JF.make_quantized_serve_step(jcfg)(jq, jcache, jnp.asarray(tok),
                                                 jnp.asarray(pos))
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    tcache = params_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    got, _ = F.make_quantized_serve_step(tcfg)(
        tq, tree_map(torch.clone, tcache), torch.from_numpy(tok),
        torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    fp, _ = F.make_serve_step(tcfg)(tparams, tcache, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
    a, b = fp[:, 0].numpy(), got[:, 0].numpy()
    cos = (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos > 0.99
    assert (a.argmax(-1) == b.argmax(-1)).all()
