"""One-device training in the port against the JAX package's: AdamW and
the schedules, the train step's microbatching and every remat mode, the
presets, the auxiliary MoE loss, the synthetic data pipeline, and the
refusal of gradients by the Hopper kernels' entry points
(tests/test_torch_train_step.py holds the train step of every family).

Reduced configs in float32 on the JAX parameters carried over by
``repro_torch.models.convert``, the same NumPy batches into both packages.
Both unembeddings run without their bf16 cast and both MoE routers on the
unrounded input (``f32_heads``), for the reason tests/test_torch_models.py
and tests/test_torch_moe.py give: a 1e-7 difference upstream can flip one
bf16 rounding and move a logit by ~1e-3.

Tolerances: AdamW and the schedules on the same inputs 1e-6 (float32
elementwise arithmetic; ``b ** count`` may differ by an ulp); the train
step's loss and grad norm 1e-5 relative and its parameters 1e-5 after
one and two steps.  The step runs with AdamW's eps at 1e-3 there: at the
default 1e-8 a parameter whose gradient is ~1e-8 moves by
``lr * g / (|g| + eps)``, anywhere in [-lr, lr] for a gradient within its
own float32 rounding (~1e-7) of zero, so the two packages' parameters
could differ by up to 2 lr; with eps at 1e-3 the move is a Lipschitz
function of the gradient.  The update at the default eps is held on shared
gradients (``test_adamw_update_matches_jax``).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import layers as JL
from repro.models import moe as JM
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.parallel.rules import ParallelismConfig as JaxParallelismConfig
from repro.runtime import steps as JRS
from repro_torch.configs.base import get_config
from repro_torch.core.regions import Impl
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import factory as F
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import moe as M
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.optim import schedule
from repro_torch.parallel.presets import parallelism_for
from repro_torch.parallel.rules import ParallelismConfig
from repro_torch.runtime import steps as RS

TOL = 1e-6
STEP_TOL = 1e-5
FAMILIES = ("mistral-nemo-12b", "falcon-mamba-7b", "recurrentgemma-2b",
            "mixtral-8x7b", "whisper-small", "paligemma-3b")
REMATS = ("none", "dots", "full", "2level")
LR = 1e-2


def _cfgs(arch):
    # MoE: capacity lifted so that splitting the batch into microbatches
    # (smaller routing groups) keeps the same tokens (tests/test_archs.py)
    kw = {"capacity_factor": 16.0} if "mixtral" in arch else {}
    return (dataclasses.replace(jax_get_config(arch).reduced(),
                                dtype="float32", **kw),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                **kw))


def _paths(tree, prefix=""):
    """{path: leaf} of a nested-dict tree of arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_paths(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy()}
    return {prefix: np.asarray(tree, np.float32)}


def _close_trees(got, want, tol, what):
    got, want = _paths(got), _paths(want)
    assert got.keys() == want.keys(), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                   err_msg=f"{what}{k}")


@pytest.fixture
def f32_heads(monkeypatch):
    """Both unembeddings as float32 products without the bf16 cast, both
    MoE routers on the unrounded input (see the module docstring)."""
    def jax_unembed(x, w, tied):
        return jnp.einsum("...d,vd->...v" if tied else "...d,dv->...v",
                          x.astype(jnp.float32), w)

    def torch_unembed(x, w, tied):
        return x.float() @ (w.t() if tied else w).float()

    monkeypatch.setattr(JL, "unembed", jax_unembed)
    monkeypatch.setattr(L, "unembed", torch_unembed)
    names = {n: getattr(jnp, n) for n in dir(jnp) if not n.startswith("__")}
    monkeypatch.setattr(JM, "jnp", types.SimpleNamespace(
        **{**names, "bfloat16": jnp.float32}))
    monkeypatch.setattr(M, "_router_logits",
                        lambda x, w: x.float() @ w.float())


def _batch(cfg, b=4, s=12, seed=3):
    """One NumPy batch as (jax batch, torch batch)."""
    nb = F.synthetic_batch(cfg, b, s, seed=seed)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def _state(jcfg, seed=0):
    """(jax train state, the port's copy of it)."""
    jstate = JRS.init_train_state(jcfg, jax.random.PRNGKey(seed))
    return jstate, params_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")


# ---------------------------------------------------------------------------
# AdamW and the schedules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moment_dtype):
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "stack": {"w": (3, 4, 5), "b": (3, 5)}, "n": (7,)}
    params = tree_map(lambda s: rng.standard_normal(s).astype(np.float32),
                      shapes)
    cfg = adamw.AdamWConfig(moment_dtype=moment_dtype, clip_norm=0.5)
    jcfg = jadamw.AdamWConfig(moment_dtype=moment_dtype, clip_norm=0.5)
    jp = tree_map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    js, ts = jadamw.init_state(jp, jcfg), adamw.init_state(tp, cfg)
    for step in range(4):
        grads = tree_map(lambda s: rng.standard_normal(s).astype(np.float32)
                         * 10.0 ** (step - 2), shapes)
        lr = 0.05 * (step + 1)
        jp, js, jm = jadamw.update(tree_map(jnp.asarray, grads), js, jp,
                                   jnp.float32(lr), jcfg)
        tp, ts, tm = adamw.update(tree_map(torch.from_numpy, grads), ts, tp,
                                  torch.tensor(lr), cfg)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=TOL)
        _close_trees(tp, jp, TOL, f"params after step {step}")
        _close_trees(ts["m"], js["m"], TOL, "m")
        _close_trees(ts["v"], js["v"], TOL, "v")
        assert int(ts["count"]) == int(js["count"]) == step + 1
        assert ts["m"]["w"].dtype == getattr(torch, moment_dtype)


def test_adamw_updates_in_place_in_chunks(monkeypatch):
    """The update writes params and moments in place; chunks of a leaf
    smaller than the leaf give the same values."""
    rng = np.random.default_rng(1)
    p = {"w": torch.from_numpy(rng.standard_normal((9, 7)).astype(np.float32))}
    g = {"w": torch.from_numpy(rng.standard_normal((9, 7)).astype(np.float32))}
    cfg = adamw.AdamWConfig()
    whole = tree_map(torch.clone, p)
    adamw.update(g, adamw.init_state(whole, cfg), whole, torch.tensor(0.1),
                 cfg)
    monkeypatch.setattr(adamw, "CHUNK", 5)
    state = adamw.init_state(p, cfg)
    ptr, mptr = p["w"].data_ptr(), state["m"]["w"].data_ptr()
    out, new_state, _ = adamw.update(g, state, p, torch.tensor(0.1), cfg)
    assert out["w"].data_ptr() == ptr and new_state["m"]["w"].data_ptr() == mptr
    assert torch.equal(out["w"], whole["w"])


def test_schedules_match_jax():
    kw = dict(peak_lr=3e-3, warmup_steps=10, total_steps=50)
    for step in range(0, 60, 3):
        want = float(jschedule.cosine_with_warmup(jnp.int32(step), **kw))
        got = schedule.cosine_with_warmup(torch.tensor(step, dtype=torch.int32),
                                          **kw)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(got.item(), want, rtol=TOL)
        np.testing.assert_allclose(
            schedule.cosine_with_warmup(step, **kw).item(), want, rtol=TOL)
        assert schedule.constant(torch.tensor(step), peak_lr=1e-2).item() == \
            float(jschedule.constant(jnp.int32(step), peak_lr=1e-2))


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ("mistral-nemo-12b", "mixtral-8x7b",
                                  "recurrentgemma-2b"))
def test_microbatched_grad_accumulation_matches(arch):
    """k=2 gradient accumulation against k=1 (tests/test_archs.py), and the
    k=2 step against JAX's k=2 step."""
    jcfg, tcfg = _cfgs(arch)
    jb, tb = _batch(tcfg, b=4, s=16)
    metrics, states = {}, {}
    for k in (1, 2):
        step = RS.make_train_step(tcfg, ParallelismConfig(remat="none",
                                                          microbatch=k))
        states[k], metrics[k] = step(_state(jcfg)[1], tb)
    assert abs(metrics[1]["loss"].item() - metrics[2]["loss"].item()) < 5e-4
    jstate, _ = _state(jcfg)
    _, jm = jax.jit(JRS.make_train_step(
        jcfg, JaxParallelismConfig(remat="none", microbatch=2)))(jstate, jb)
    np.testing.assert_allclose(metrics[2]["loss"].item(), float(jm["loss"]),
                               rtol=STEP_TOL)
    np.testing.assert_allclose(metrics[2]["grad_norm"].item(),
                               float(jm["grad_norm"]), rtol=1e-4)


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.count += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ("mistral-nemo-12b", "recurrentgemma-2b",
                                  "mixtral-8x7b", "whisper-small"))
def test_remat_modes_give_equal_loss_and_grads(arch):
    """Every remat mode: the same loss bit for bit and the same gradients;
    and the modes differ in what the backward recomputes: "full" redoes
    the stack's matrix products, "dots" saves them (its backward runs as
    many as "none"'s), and "2level" redoes them for its outer groups."""
    _, tcfg = _cfgs(arch)
    tcfg = dataclasses.replace(tcfg, num_layers=4 * len(
        lm.layer_plan(tcfg)[0]))          # 4 units: 2level makes 2 groups
    params = F.init_params(tcfg, torch.Generator().manual_seed(0))
    _, tb = _batch(tcfg, b=2, s=8)
    out, backward_mms = {}, {}
    for remat in REMATS:
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        it = iter(leaves)
        loss = F.make_loss(tcfg, remat=remat)(tree_map(lambda _: next(it),
                                                        params), tb)
        with _CountMatmuls() as counter:
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out[remat] = loss.item(), grads
        backward_mms[remat] = counter.count
    for remat in REMATS[1:]:
        assert out[remat][0] == out["none"][0], remat
        for g, want in zip(out[remat][1], out["none"][1]):
            if want is None:
                assert g is None
            else:
                torch.testing.assert_close(g, want, rtol=0, atol=1e-6)
    assert backward_mms["dots"] == backward_mms["none"]
    assert backward_mms["full"] > backward_mms["dots"]
    assert backward_mms["2level"] > backward_mms["dots"]


def test_remat_rejects_an_unknown_mode():
    _, tcfg = _cfgs("mistral-nemo-12b")
    params = F.init_params(tcfg, torch.Generator().manual_seed(0))
    _, tb = _batch(tcfg, b=1, s=4)
    with pytest.raises(ValueError, match="remat"):
        F.make_loss(tcfg, remat="everything")(params, tb)


def test_train_presets_match_jax():
    from repro.configs.base import SHAPES as JSHAPES
    from repro.parallel.presets import parallelism_for as jax_parallelism_for
    from repro_torch.configs.base import SHAPES
    for arch in FAMILIES + ("qwen2-72b", "kimi-k2-1t-a32b"):
        for shape in ("train_4k", "decode_32k"):
            for axis in (1, 16):
                want = jax_parallelism_for(jax_get_config(arch),
                                           JSHAPES[shape], model_axis=axis)
                got = parallelism_for(get_config(arch), SHAPES[shape],
                                      model_axis=axis)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(ParallelismConfig()) == dataclasses.asdict(
        JaxParallelismConfig())


# ---------------------------------------------------------------------------
# MoE auxiliary loss
# ---------------------------------------------------------------------------
def test_aux_load_balance_loss_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((24, 4)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.argsort(-probs, -1)[:, :2].astype(np.int32)
    want = float(JM.aux_load_balance_loss(jnp.asarray(probs), jnp.asarray(idx),
                                          4))
    got = M.aux_load_balance_loss(torch.from_numpy(probs),
                                  torch.from_numpy(idx), 4)
    np.testing.assert_allclose(got.item(), want, rtol=TOL)
    # differentiable in the router's probabilities
    p = torch.from_numpy(probs).requires_grad_(True)
    M.aux_load_balance_loss(p, torch.from_numpy(idx), 4).backward()
    assert p.grad is not None and p.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# Synthetic data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ("mistral-nemo-12b", "whisper-small",
                                  "paligemma-3b"))
def test_synthetic_lm_is_deterministic_and_shares_jax_table(arch):
    jcfg, tcfg = _cfgs(arch)
    data = SyntheticLM(tcfg, 3, 20, seed=7)
    np.testing.assert_array_equal(data._next_tok,
                                  JaxSyntheticLM(jcfg, 3, 20, seed=7)._next_tok)
    first = [next(data) for _ in range(3)]
    again = SyntheticLM(tcfg, 3, 20, seed=7)
    again.load_state_dict({"seed": 7, "step": 1})
    for want in first[1:]:
        got = next(again)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert data.state_dict() == {"seed": 7, "step": 3}
    toks = first[0]["tokens"]
    assert toks.shape == (3, 20) and toks.dtype == np.int32
    assert 0 <= toks.min() and toks.max() < min(tcfg.vocab_size, 512)
    # 80% of the transitions follow the table (20% are noise, some of which
    # land on the table's token anyway)
    follows = (data._next_tok[toks[:, :-1]] == toks[:, 1:]).mean()
    assert follows > 0.6
    key = F.frontend_key(tcfg)
    if key is not None:
        fe = first[0][key]
        assert fe.shape == (3, tcfg.frontend_seq, tcfg.frontend_dim)
        np.testing.assert_array_equal(fe, F.bf16_values(fe))
    assert not np.array_equal(first[0]["tokens"], first[1]["tokens"])


# ---------------------------------------------------------------------------
# The Hopper entry points refuse gradients
# ---------------------------------------------------------------------------
def _entry_points():
    from repro_torch.kernels import (decode_attention, fir, flash_attention,
                                     mriq, rglru_scan, rmsnorm, ssm_scan)
    f = torch.float32
    c = lambda *s: torch.zeros(s, dtype=torch.complex64)
    z = lambda *s: torch.zeros(s, dtype=f)
    return {
        "fir_bank": (fir.fir_filter_bank, (c(2, 16), c(2, 4))),
        "compute_q": (mriq.mriq_compute_q, tuple(z(8) for _ in range(7))),
        "attn_core": (flash_attention.flash_attention,
                      (z(1, 2, 8, 16), z(1, 2, 8, 16), z(1, 2, 8, 16))),
        "decode_attn": (decode_attention.decode_attention,
                        (z(1, 2, 1, 16), z(1, 2, 8, 16), z(1, 2, 8, 16),
                         torch.zeros(1, 8, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32))),
        "ssm_scan": (ssm_scan.ssm_scan, (z(1, 4, 3, 2), z(1, 4, 3, 2),
                                         z(1, 4, 2), z(1, 3, 2))),
        "rglru_scan": (rglru_scan.rglru_scan, (z(1, 4, 3), z(1, 4, 3),
                                               z(1, 3))),
        "rmsnorm": (rmsnorm.rmsnorm, (z(3, 8), z(8))),
    }


@pytest.mark.parametrize("region", ["fir_bank", "compute_q", "attn_core",
                                    "decode_attn", "ssm_scan", "rglru_scan",
                                    "rmsnorm"])
def test_hopper_entry_points_refuse_gradients(region, monkeypatch):
    """A gradient-requiring input under grad mode raises before any device
    check or build (here: on CPU tensors, where the wrapper would run its
    plain version, and with the plain version and the build poisoned);
    under no_grad the same call gets past the check."""
    from repro_torch.kernels import _build
    fn, args = _entry_points()[region]
    module = __import__(fn.__module__, fromlist=["_"])
    plain = [n for n in vars(module) if n.endswith("_plain")]
    for name in plain:
        monkeypatch.setattr(module, name, lambda *a, **k: pytest.fail("ran"))
    monkeypatch.setattr(_build, "load", lambda *a: pytest.fail("built"))
    grad_args = list(args)
    grad_args[0] = args[0].clone().requires_grad_(True)
    before = fn.launches
    with pytest.raises(RuntimeError, match=rf"{region} region's hopper kernel "
                       r"has no backward.*ref/offload"):
        fn(*grad_args)
    assert fn.launches == before
    monkeypatch.undo()
    with torch.no_grad():
        fn(*grad_args)                    # the plain version on the CPU
    fn(*args)                             # no input requires grad


def test_train_step_under_a_hopper_impl_raises():
    _, tcfg = _cfgs("mistral-nemo-12b")
    state = RS.init_train_state(tcfg, torch.Generator().manual_seed(0))
    _, tb = _batch(tcfg, b=2, s=8)
    step = RS.make_train_step(tcfg, ParallelismConfig(remat="none"),
                              impl=Impl({"attn_core": "hopper"}))
    with pytest.raises(RuntimeError, match="attn_core region's hopper kernel"):
        step(state, tb)
    # serving the same params under hopper needs no gradient: no raise
    with torch.no_grad():
        F.make_forward(tcfg, impl=Impl({"attn_core": "hopper"}))(
            state["params"], tb)
