"""The port's config registry against the JAX package's: the six configs of
slice 9 (three dense decoders, three MoE decoders) field for field, the
analytic parameter counts of every arch (the two frontends' in
tests/test_torch_frontends.py too), the registry lists, and the reduced dense
configs' templates and forward logits on the JAX parameters carried over
with ``repro_torch.models.convert``.

Reduced configs in float32 with both unembeddings in float32 (see
tests/test_torch_models.py): logits to 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.configs import get_config as jax_get_config
from repro.models import factory as JF
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch.configs import base as B
from repro_torch.configs.base import get_config
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy

LOGIT_TOL = 1e-4
NEW_DENSE = ("phi3-medium-14b", "qwen2-72b", "deepseek-67b")
NEW_MOE = ("mixtral-8x7b", "arctic-480b", "kimi-k2-1t-a32b")
PORTED = tuple(B.ARCH_IDS) + tuple(B.BONUS_ARCH_IDS)


@pytest.mark.parametrize("arch", NEW_DENSE + NEW_MOE)
def test_config_and_reduced_config_equal_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        jax_get_config(arch))
    assert dataclasses.asdict(get_config(arch).reduced()) == \
        dataclasses.asdict(jax_get_config(arch).reduced())


def test_registry_lists_follow_jax():
    """Every JAX arch, in the JAX order, the two frontend archs included;
    mixtral stays a bonus arch."""
    assert B.ARCH_IDS == JB.ARCH_IDS
    assert B.BONUS_ARCH_IDS == JB.BONUS_ARCH_IDS == ("mixtral-8x7b",)
    assert {get_config(a).name for a in PORTED} == set(PORTED)


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("reduced", [False, True])
def test_param_counts_equal_jax(arch, reduced):
    t, j = get_config(arch), jax_get_config(arch)
    if reduced:
        t, j = t.reduced(), j.reduced()
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()


def test_mixtral_counts_and_the_depth_cut():
    """The figures the card's serving phase prints: 46.7 B parameters at
    32 layers (more than 80 GB in bf16); 16 layers fit."""
    full = get_config("mixtral-8x7b")
    assert full.param_count() == 46_702_792_704
    assert full.active_param_count() == 12_879_925_248
    cut = dataclasses.replace(full, num_layers=16)
    per_layer = (full.param_count() - cut.param_count()) // 16
    assert per_layer == 1_451_270_144
    assert 2 * cut.param_count() < 80e9 < 2 * full.param_count()


@pytest.mark.parametrize("arch", NEW_DENSE)
def test_dense_templates_mirror_jax(arch):
    jt = JLM.model_template(jax_get_config(arch).reduced())
    tt = lm.model_template(get_config(arch).reduced())

    def walk(j, t):
        assert set(j) == set(t)
        for k in j:
            if isinstance(j[k], dict):
                walk(j[k], t[k])
            else:
                assert (tuple(j[k].shape), j[k].init, j[k].dtype) == (
                    t[k].shape, t[k].init, t[k].dtype), k
    walk(jt, tt)
    has_bias = "bq" in tt["stack"]["l0"]["attn"]
    assert has_bias == (arch == "qwen2-72b")


@pytest.fixture
def f32_logits(monkeypatch):
    monkeypatch.setattr(JL, "unembed", lambda x, w, tied: jnp.einsum(
        "...d,dv->...v", x.astype(jnp.float32), w))
    monkeypatch.setattr(L, "unembed", lambda x, w, tied: x.float() @ w.float())


@pytest.mark.parametrize("arch", NEW_DENSE)
def test_reduced_dense_forward_matches_jax(arch, f32_logits):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    jparams = JF.init_params(jcfg, jax.random.PRNGKey(1))
    if arch == "qwen2-72b":
        # the template's biases are zeros: draw them, so they count
        rng = np.random.default_rng(0)
        attn = jparams["stack"]["l0"]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(rng.standard_normal(attn[name].shape)
                                     .astype(np.float32) * 0.1)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 16)
                                             ).astype(np.int32)
    want = JLM.forward(jparams, jnp.asarray(toks), cfg=jcfg)
    got = lm.forward(tparams, torch.from_numpy(toks), cfg=tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
