"""Static extraction on the port (``repro_torch.core.extract``) against the
JAX package's (``repro.core.extract``): the same NumPy inputs and, for the
models, the JAX parameters carried over by ``repro_torch.models.convert``.

Recognizer positives on the reduced archs' known blocks (shapes equal to
the JAX matches'), legality negatives (dtype, escape, side effect, while,
cond), the binder's fidelity under variant substitution, stitching, the
plan-cache keys, and ``rmsnorm``'s plain version against the JAX kernel.

The JAX extractor misses ``mlp_core`` under jax 0.9.0 (its wrapper
primitive is named ``jit``, not ``pjit``), ``fir_bank`` on tdFIR and
``moe_dispatch``; the port is held to the JAX code's stated intent, the
``COVERAGE`` table of ``tests/test_extract.py``, not to those misses.

Tolerances: a rebuilt program against the program it was captured from,
exact (1e-6 for tdFIR's complex pipeline); the rebuilt float32 models
against the JAX forwards, 1e-5 (summation order; both unembeddings swapped
for their float32 product, as in ``tests/test_torch_models.py``); a
substituted ``offload`` variant, 5e-2 relative (bf16 models) or 1e-3
(tdFIR), as ``tests/test_extract.py``; ``rmsnorm`` 1e-5 in float32 and
2e-2 in bf16, as ``tests/test_kernels.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as Fn
from torch._higher_order_ops.while_loop import while_loop

from repro.configs import get_config as jax_get_config
from repro.core import extract as JE
from repro.core.regions import Impl as JImpl
from repro.kernels import ref as JR
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.models import factory as JF
from repro.models import layers as JL
from repro_torch.apps import mriq as torch_mriq
from repro_torch.apps import tdfir as T
from repro_torch.configs.base import get_config
from repro_torch.configs.paper_apps import TdFirConfig
from repro_torch.core import extract as E
from repro_torch.core.intensity import analyze_region, count_loops
from repro_torch.core.loops import fori_loop
from repro_torch.core.plan_cache import (PlanCache, measurement_cache_key,
                                         plan_cache_key)
from repro_torch.core.planner import AutoOffloader, PlannerConfig
from repro_torch.core.program import Region, meta
from repro_torch.core.regions import (Impl, register_variant,
                                      unregister_variant, variants)
from repro_torch.core.resources import precompile
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels.ref import rmsnorm_plain
from repro_torch.models import factory as F
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.offload_program import make_lm_program
from repro_torch.models.ssm import associative_scan

# Family -> named extractor tests, one list per polarity, as in
# tests/test_extract.py: every family in ``extract.FAMILIES`` has at least
# one positive and one negative test, and each named function exists here.
COVERAGE = {
    "attn_core": {
        "positive": ["test_attn_core_rediscovered_with_arch_shapes"],
        "negative": ["test_attn_f16_rejected_by_dtype_gate"]},
    "mlp_core": {
        "positive": ["test_mlp_core_rediscovered_with_arch_shapes"],
        "negative": ["test_mlp_escaping_intermediate_rejected"]},
    "ssm_scan": {
        "positive": ["test_ssm_scan_rediscovered_with_arch_shapes"],
        "negative": ["test_ssm_side_effect_rejected"]},
    "rglru_scan": {
        "positive": ["test_rglru_scan_rediscovered_with_arch_shapes"],
        "negative": ["test_rglru_while_trip_count_rejected"]},
    "fir_bank": {
        "positive": ["test_fir_bank_rediscovered"],
        "negative": ["test_fir_while_trip_count_rejected"]},
    "moe_dispatch": {
        "positive": ["test_torch_moe_dispatch_rediscovered"],
        "negative": ["test_torch_moe_unbounded_routing_rejected"]},
    "mlp_gelu": {
        "positive": ["test_gelu_mlp_rediscovered"],
        "negative": ["test_gelu_mlp_escaping_intermediate_rejected"]},
    "conv_stem": {
        "positive": ["test_conv_stem_rediscovered"],
        "negative": ["test_dilated_conv_rejected_with_diagnostic"]},
    "rmsnorm": {
        "positive": ["test_rmsnorm_rediscovered"],
        "negative": ["test_rmsnorm_f16_rejected_by_dtype_gate"]},
}

ARCHS = ("mistral-nemo-12b", "falcon-mamba-7b", "recurrentgemma-2b",
         "whisper-small", "paligemma-3b")
SEQ = 32
UNIVERSE = frozenset(E.FAMILIES)
LOGIT_TOL = 1e-5
SUB_RTOL = 5e-2
NORM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _tokens(vocab: int, seq: int = SEQ) -> np.ndarray:
    return np.random.default_rng(1).integers(0, vocab, (1, seq), dtype=np.int32)


def _pair(arch: str, dtype: str = "bfloat16"):
    """(jax cfg, jax fn, jax args, torch cfg, torch fn, torch args): the
    arch's reduced all-ref forward in both packages, on the same weights
    (the JAX draw, converted) and tokens; a frontend arch's synthetic
    patches or frames (bf16 values) are closed over, as the JAX tests'
    ``_trace_arch`` does."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    jparams = JF.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tok = _tokens(tcfg.vocab_size)
    key = F.frontend_key(tcfg)
    jkw, tkw = {}, {}
    if key is not None:
        fe = F.synthetic_batch(tcfg, 1, SEQ, seed=1)[key]
        jkw, tkw = {key: jnp.asarray(fe, jnp.bfloat16)}, {
            key: torch.from_numpy(fe)}
    jfwd, tfwd = JF.make_forward(jcfg, JImpl()), F.make_forward(tcfg, Impl())
    return (jcfg, lambda t: jfwd(jparams, {"tokens": t, **jkw}),
            (jnp.asarray(tok),),
            tcfg, lambda t: tfwd(tparams, {"tokens": t, **tkw}),
            (torch.from_numpy(tok),))


@pytest.fixture(scope="module")
def reports():
    """arch -> (torch cfg, torch fn, torch args, torch report, jax report)."""
    out = {}
    for arch in ARCHS:
        _, jfn, jargs, tcfg, tfn, targs = _pair(arch)
        out[arch] = (tcfg, tfn, targs, E.extract(tfn, targs, name=arch),
                     JE.extract(jfn, jargs, name=arch))
    return out


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


def _legal(report, family):
    return [m for m in report.legal_matches if m.family == family]


def _rep(matches):
    return max(matches, key=lambda m: m.analysis.flops if m.analysis else 0.0)


def _cnormal(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _region_calls(program) -> int:
    return sum(1 for n in program.graph_module.graph.nodes
               if n.op == "call_function"
               and getattr(n.target, "__name__", "").startswith("region_"))


def test_coverage_table_names_every_family_both_ways():
    assert set(COVERAGE) == UNIVERSE == set(E.RECOGNIZERS)
    for family, tests in COVERAGE.items():
        for polarity in ("positive", "negative"):
            assert tests[polarity], (family, polarity)
            for name in tests[polarity]:
                assert callable(globals().get(name)), name


# ---------------------------------------------------------------------------
# The reduced archs: families, shapes, loop census
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_families_match_ground_truth_and_contain_jax(reports, arch):
    _, _, _, report, jreport = reports[arch]
    found = set(report.families) & UNIVERSE
    truth = ({r.name for r in make_lm_program(arch, device="cpu").regions}
             & UNIVERSE) | {"rmsnorm"}
    assert found == truth, report.summary()
    assert set(jreport.families) & UNIVERSE <= found


@pytest.mark.parametrize("arch", ARCHS)
def test_representative_arg_shapes_match_jax(reports, arch):
    _, _, _, report, jreport = reports[arch]
    jax_families = set(jreport.families) & UNIVERSE
    assert jax_families, jreport.summary()
    for family in jax_families:
        got = _rep(_legal(report, family)).arg_shapes()
        assert got == _rep(_legal(jreport, family)).arg_shapes(), family


@pytest.mark.parametrize("arch", ARCHS)
def test_loop_count_is_the_census(reports, arch):
    _, fn, args, report, _ = reports[arch]
    assert report.loop_count == count_loops(fn, *args) > 0


def test_attn_core_rediscovered_with_arch_shapes(reports):
    cfg, _, _, report, _ = reports["recurrentgemma-2b"]
    hits = _legal(report, "attn_core")
    assert hits, report.summary()
    q, k, v = hits[0].invars
    hd = cfg.resolved_head_dim
    assert E._shape(q) == (1, cfg.num_heads, SEQ, hd)
    assert E._shape(k) == (1, cfg.num_kv_heads, SEQ, hd)
    assert E._shape(v) == E._shape(k)
    # recurrentgemma's local attention: causal, with its sliding window
    assert hits[0].static_kwargs == {"causal": True,
                                     "window": cfg.attn_window}
    mistral = _legal(reports["mistral-nemo-12b"][3], "attn_core")
    assert mistral[0].static_kwargs == {"causal": True, "window": 0}


def test_mlp_core_rediscovered_with_arch_shapes(reports):
    cfg, _, _, report, _ = reports["recurrentgemma-2b"]
    hits = _legal(report, "mlp_core")
    assert hits, report.summary()
    x, wg, wu, wd = hits[0].invars
    assert E._shape(wg) == (cfg.d_model, cfg.d_ff)
    assert E._shape(wu) == (cfg.d_model, cfg.d_ff)
    assert E._shape(wd) == (cfg.d_ff, cfg.d_model)
    assert E._shape(x) == (1, SEQ, cfg.d_model)


def test_mlp_core_does_not_claim_the_mamba_gates(reports):
    _, _, _, report, _ = reports["falcon-mamba-7b"]
    gates = [n for n in report.graph_module.graph.nodes if E._op(n) == "silu"]
    assert len(gates) >= 2
    assert not [m for m in report.matches if m.family == "mlp_core"]


def test_rglru_scan_rediscovered_with_arch_shapes(reports):
    cfg, _, _, report, _ = reports["recurrentgemma-2b"]
    hits = _legal(report, "rglru_scan")
    assert hits, report.summary()
    a, b, h0 = hits[0].invars
    dr = cfg.rglru_d_rnn or cfg.d_model
    assert E._shape(a) == (1, SEQ, dr)
    assert E._shape(b) == (1, SEQ, dr)
    assert E._shape(h0) == (1, dr)


def test_rmsnorm_rediscovered(reports):
    cfg, _, _, report, _ = reports["recurrentgemma-2b"]
    hits = _legal(report, "rmsnorm")
    assert hits, report.summary()
    x, w = hits[0].invars
    assert E._shape(w) == (cfg.d_model,)
    assert E._shape(x)[-1] == cfg.d_model
    assert hits[0].static_kwargs == {"eps": cfg.norm_eps}
    # two per layer and the final norm
    assert len(hits) == 2 * cfg.num_layers + 1


def test_ssm_scan_rediscovered_with_arch_shapes(reports):
    cfg, _, _, report, _ = reports["falcon-mamba-7b"]
    hits = _legal(report, "ssm_scan")
    assert hits, report.summary()
    a, bx, c, h0 = hits[0].invars
    assert E._shape(a) == (1, SEQ, cfg.d_inner, cfg.ssm_state)
    assert E._shape(bx) == E._shape(a)
    assert E._shape(c) == (1, SEQ, cfg.ssm_state)
    assert E._shape(h0) == (1, cfg.d_inner, cfg.ssm_state)


def _tdfir_inputs(cfg=TdFirConfig(16, 64, 1024)):
    rng = np.random.default_rng(7)
    return _cnormal(rng, cfg.n_banks, cfg.n_samples), \
        _cnormal(rng, cfg.n_banks, cfg.n_taps)


def test_fir_bank_rediscovered():
    x, h = (torch.from_numpy(a) for a in _tdfir_inputs())
    report = E.extract(T._pipeline(Impl()), (x, h), name="tdfir")
    hits = _legal(report, "fir_bank")
    assert hits, report.summary()
    xm, hm = hits[0].invars
    assert E._shape(xm) == tuple(x.shape) and E._shape(hm) == tuple(h.shape)
    assert E._dtype(xm) == "complex64"
    assert report.loop_count == count_loops(T._pipeline(Impl()), x, h) == 4


# ---------------------------------------------------------------------------
# Negatives: the legality analyzer rejects perturbed programs
# ---------------------------------------------------------------------------
def test_attn_f16_rejected_by_dtype_gate():
    q = torch.zeros(1, 4, 128, 16, dtype=torch.float16)
    kv = torch.zeros(1, 2, 128, 16, dtype=torch.float16)
    report = E.extract(
        lambda q, k, v: L.chunked_attention(q, k, v, q_chunk=64, k_chunk=64),
        (q, kv, kv), name="attn_f16")
    matches = [m for m in report.matches if m.family == "attn_core"]
    assert matches, report.summary()
    assert not matches[0].legal
    assert "dtype" in matches[0].reason


def test_mlp_escaping_intermediate_rejected():
    """Returning the gate projection alongside the MLP output makes a
    covered intermediate escape the region — not bindable."""
    x = torch.zeros(32, 64, dtype=torch.bfloat16)
    wg = torch.zeros(64, 128, dtype=torch.bfloat16)
    wd = torch.zeros(128, 64, dtype=torch.bfloat16)

    def leaky(x, wg, wu, wd):
        g = x @ wg
        return (Fn.silu(g) * (x @ wu)) @ wd, g

    report = E.extract(leaky, (x, wg, wg, wd), name="mlp_leak")
    assert not _legal(report, "mlp_core"), report.summary()
    rejs = [r for r in report.rejections
            if r.family == "mlp_core" and r.stage == "legality"]
    assert rejs and "escapes" in rejs[0].reason


def test_ssm_side_effect_rejected():
    """Logging each chunk's state into a program input is a mutation that
    survives functionalization: the recognizer still sees the affine
    carry, legality refuses to slice it."""
    b, s, d, n, chunk = 1, 16, 8, 4, 4
    a = torch.full((b, s, d, n), 0.5, dtype=torch.bfloat16)
    bx = torch.ones(b, s, d, n, dtype=torch.bfloat16)
    c = torch.ones(b, s, n, dtype=torch.bfloat16)
    h0 = torch.zeros(b, d, n)

    def noisy_scan(a, bx, c, h0, log):
        nc = s // chunk
        a, bx = a.reshape(b, nc, chunk, d, n), bx.reshape(b, nc, chunk, d, n)
        c = c.reshape(b, nc, chunk, n)
        y = torch.empty(b, s, d, dtype=a.dtype)

        def body(i, h):
            cum_a, cum_b = associative_scan(a[:, i], bx[:, i])
            h_t = cum_a * h[:, None] + cum_b
            log[i] = h_t.float().abs().amax()
            y[:, i * chunk:(i + 1) * chunk] = torch.einsum(
                "btdn,btn->btd", h_t, c[:, i])
            return h_t[:, -1]

        return y, fori_loop(0, nc, body, h0.to(a.dtype))

    report = E.extract(noisy_scan, (a, bx, c, h0, torch.zeros(s // chunk)),
                       name="ssm_noisy")
    bad = [m for m in report.matches
           if m.family == "ssm_scan" and not m.legal]
    assert bad, report.summary()
    assert "side effect" in bad[0].reason


def test_rglru_while_trip_count_rejected():
    """The same affine recurrence written as a while loop has no visible
    trip count — recognized as a loop site but never legal."""
    def while_rnn(a, b, h0, n):
        _, h = while_loop(lambda i, h: i < n,
                          lambda i, h: (i + 1, a * h + b),
                          (torch.zeros((), dtype=torch.int64), h0))
        return h

    a, b, h0 = torch.full((1, 64), 0.9), torch.ones(1, 64), torch.zeros(1, 64)
    report = E.extract(while_rnn, (a, b, h0, torch.tensor(17)),
                       name="while_rnn")
    bad = [m for m in report.matches if not m.legal]
    assert bad and bad[0].family == "rglru_scan", report.summary()
    assert "trip count" in bad[0].reason
    assert report.legal_matches == []
    assert [s.kind for s in report.sites] == ["while"]


def test_fir_while_trip_count_rejected():
    """A tap loop over a traced tap count (an index gather in a while body)
    is the paper's 'loop with undeterminable iteration count'."""
    def while_fir(x, h, taps):
        pad = Fn.pad(x, (0, h.shape[1]))
        n = x.shape[1]

        def body(j, acc):
            sl = torch.index_select(pad, 1, j + torch.arange(n))
            return j + 1, acc + sl * h[:, 0:1]

        _, acc = while_loop(lambda j, acc: j < taps, body,
                            (torch.zeros((), dtype=torch.int64),
                             torch.zeros_like(x)))
        return acc

    x = torch.ones(4, 64, dtype=torch.complex64)
    h = torch.ones(4, 8, dtype=torch.complex64)
    report = E.extract(while_fir, (x, h, torch.tensor(5)), name="while_fir")
    bad = [m for m in report.matches if not m.legal]
    assert bad and bad[0].family == "fir_bank", report.summary()
    assert "trip count" in bad[0].reason


def test_rmsnorm_f16_rejected_by_dtype_gate():
    x = torch.zeros(8, 64, dtype=torch.float16)
    w = torch.zeros(64, dtype=torch.float16)
    report = E.extract(lambda x, w: L.rms_norm(x, w, 1e-6), (x, w),
                       name="rms_f16")
    matches = [m for m in report.matches if m.family == "rmsnorm"]
    assert matches, report.summary()
    assert not matches[0].legal and "dtype" in matches[0].reason


def test_rmsnorm_inside_cond_branch_rejected():
    """The port's ``cond`` container: a block that runs only on one branch
    is recognized in the branch's subgraph but never legal."""
    def gated(x, w, flag):
        return torch.cond(flag.sum() > 0, lambda x, w: L.rms_norm(x, w),
                          lambda x, w: x.clone(), (x, w))

    report = E.extract(gated, (torch.randn(8, 64), torch.randn(64),
                               torch.ones(1)), name="cond_norm")
    matches = [m for m in report.matches if m.family == "rmsnorm"]
    assert matches and matches[0].path == ("cond",), report.summary()
    assert not matches[0].legal and "cond branch" in matches[0].reason


@pytest.mark.parametrize("kind", ["bool", "item"])
def test_data_dependent_capture_raises_value_error(kind):
    def branchy(x):
        return x if x.sum() > 0 else -x

    def scalar(x):
        return x * x.max().item()

    with pytest.raises(ValueError, match="_local_scalar_dense"):
        E.extract(branchy if kind == "bool" else scalar, (torch.randn(3),))


# ---------------------------------------------------------------------------
# The capture protocol of core/loops.py
# ---------------------------------------------------------------------------
def test_capture_tags_every_iteration_with_its_loop():
    def nested(x):
        def outer(i, acc):
            def inner(j, a):
                return a * x[i, j]
            return acc + fori_loop(0, 2, inner, torch.ones_like(x[0, 0]))
        return fori_loop(0, 3, outer, torch.zeros_like(x[0, 0]))

    x = torch.randn(3, 2)
    gm, stmts = E.capture(nested, (x,))
    assert [(s.trip, s.depth) for s in stmts] == [(3, 0)] + [(2, 1)] * 3
    assert [s.parent for s in stmts[1:]] == [(0, 0), (0, 1), (0, 2)]
    frames = {n.meta.get(E._LOOP_KEY) for n in gm.graph.nodes
              if n.op == "call_function"}
    for k in range(3):
        assert ((0, k), (k + 1, 0)) in frames and ((0, k), (k + 1, 1)) in frames
    torch.testing.assert_close(gm(x), nested(x), rtol=0, atol=0)
    ctx = E._Ctx(gm, stmts)
    assert [s.id for s in ctx.census()] == [0, 1] == \
        list(range(count_loops(nested, x)))


# ---------------------------------------------------------------------------
# Binder: discovered programs rebuild faithfully and substitute variants
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_discovered_lm_build_matches_jax_logits(f32_logits, arch):
    _, jfn, jargs, _, tfn, targs = _pair(arch, "float32")
    prog = E.discover(tfn, targs, name=arch)
    got = prog.build(Impl())(*targs)
    torch.testing.assert_close(got, tfn(*targs), rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jfn(*jargs)),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_discovered_lm_substitution_matches_reference():
    _, jfn, jargs, _, tfn, targs = _pair("recurrentgemma-2b")
    prog = E.discover(tfn, targs, name="recgemma")
    families = {r.name for r in prog.regions}
    assert {"attn_core", "rglru_scan", "mlp_core", "rmsnorm"} <= families
    ref = np.asarray(jfn(*jargs), np.float32)
    mixed = prog.build(Impl({"mlp_core": "offload", "rglru_scan": "offload"}))
    assert _region_calls(mixed) == 3 + 2     # 3 MLPs, 2 RG-LRU layers
    sub = mixed(*targs).numpy()
    scale = float(np.max(np.abs(ref))) + 1e-9
    assert float(np.max(np.abs(ref - sub))) / scale < SUB_RTOL


def test_tdfir_rebuild_faithful_and_substitutes():
    from repro.apps import tdfir as JT
    xn, hn = _tdfir_inputs(TdFirConfig(4, 16, 256))
    x, h = torch.from_numpy(xn), torch.from_numpy(hn)
    fn = T._pipeline(Impl())
    prog = E.discover(fn, (x, h), name="tdfir")
    assert [r.name for r in prog.regions] == ["fir_bank"]
    ref = fn(x, h)
    for a, b in zip(ref, prog.build(Impl())(x, h)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
    sub = prog.build(Impl({"fir_bank": "offload"}))
    assert _region_calls(sub) == 1
    for a, b in zip(ref, sub(x, h)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-3)
    # and the JAX all-ref pipeline, at the app tests' tolerances
    jout = JT._pipeline(JImpl())(jnp.asarray(xn), jnp.asarray(hn))
    for a, b, tol in zip(ref, jout, (3e-4, 1e-3)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                   atol=tol)


def test_rebuilt_program_announces_the_census_to_step_one():
    x, h = (torch.from_numpy(a) for a in _tdfir_inputs(TdFirConfig(4, 16, 256)))
    fn = T._pipeline(Impl())
    prog = E.discover(fn, (x, h), name="tdfir")
    built = prog.build(Impl())
    assert count_loops(built, x, h) == count_loops(fn, x, h) == \
        prog.source_loop_count
    assert analyze_region(built, x, h).flops > 0


def test_region_analysis_feeds_intensity():
    x, h = (torch.from_numpy(a) for a in _tdfir_inputs())
    report = E.extract(T._pipeline(Impl()), (x, h), name="tdfir")
    for m in report.legal_matches:
        assert m.analysis is not None
        assert m.analysis.flops > 0
        assert m.analysis.boundary_bytes > 0
        assert 0.0 < m.analysis.alignment <= 1.0


# ---------------------------------------------------------------------------
# Region stitching: adjacent legal matches fuse; escaping boundaries don't
# ---------------------------------------------------------------------------
def _norm_mlp_args():
    rng = np.random.default_rng(3)

    def bf(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return (bf(2, 16, 64), bf(64, scale=0.1), bf(64, 128, scale=0.1),
            bf(64, 128, scale=0.1), bf(128, 64, scale=0.1))


def _torch_bf16(arrays):
    return tuple(torch.from_numpy(a).to(torch.bfloat16) for a in arrays)


def _norm_mlp(x, w, wg, wu, wd):
    return L.swiglu(L.rms_norm(x, w, 1e-6), wg, wu, wd)


def test_stitched_pair_discovered_and_faithful():
    """rmsnorm feeding a SwiGLU MLP fuses into one offloadable region; the
    fused build matches the JAX reference."""
    arrays = _norm_mlp_args()
    args = _torch_bf16(arrays)
    report = E.extract(_norm_mlp, args, name="norm_mlp")
    fused = _legal(report, "rmsnorm+mlp_core")
    assert fused, report.summary()
    halves = _legal(report, "rmsnorm") + _legal(report, "mlp_core")
    assert len(fused[0].covered) == sum(len(m.covered) for m in halves)
    assert fused[0].static_kwargs["left"] == "rmsnorm"
    assert fused[0].static_kwargs["left_kwargs"] == {"eps": 1e-6}

    prog = E.discover(_norm_mlp, args, name="norm_mlp")
    assert "rmsnorm+mlp_core" in [r.name for r in prog.regions]
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    ref = np.asarray(JL.swiglu(JL.rms_norm(jargs[0], jargs[1], 1e-6),
                               *jargs[2:]), np.float32)
    scale = float(np.max(np.abs(ref))) + 1e-9
    for impl in (Impl(), Impl({"rmsnorm+mlp_core": "offload"})):
        got = prog.build(impl)(*args).float().numpy()
        assert float(np.max(np.abs(ref - got))) / scale < SUB_RTOL
    assert _region_calls(prog.build(Impl({"rmsnorm+mlp_core": "offload",
                                          "rmsnorm": "hopper"}))) == 1


def test_stitch_rejected_when_boundary_escapes():
    """If the value crossing the seam is also a program output, fusing
    would hide it — the stitcher refuses and reports stage='stitch'."""
    def leaky(x, w, wg, wu, wd):
        y = L.rms_norm(x, w, 1e-6)
        return L.swiglu(y, wg, wu, wd), y

    report = E.extract(leaky, _torch_bf16(_norm_mlp_args()), name="leak")
    assert _legal(report, "rmsnorm") and _legal(report, "mlp_core")
    assert not [m for m in report.legal_matches if "+" in m.family]
    rejs = [r for r in report.rejections if r.stage == "stitch"]
    assert rejs, report.summary()
    assert "boundary value escapes" in rejs[0].reason


def test_fused_and_split_plan_cache_keys_differ():
    args = _torch_bf16(_norm_mlp_args())
    fused = E.discover(_norm_mlp, args, name="norm_mlp")
    split = E.discover(_norm_mlp, args, name="norm_mlp",
                       families=("rmsnorm", "mlp_core"))
    cfg = PlannerConfig()
    assert plan_cache_key(fused, cfg, "cpu") != plan_cache_key(split, cfg, "cpu")
    assert measurement_cache_key(fused, "cpu") != \
        measurement_cache_key(split, "cpu")


# ---------------------------------------------------------------------------
# Planning a discovered program
# ---------------------------------------------------------------------------
def test_discovered_program_plans_and_replans_from_cache(tmp_path):
    _, _, _, tcfg, tfn, targs = _pair("mistral-nemo-12b")
    prog = E.discover(tfn, targs, name="mistral")
    assert prog.cache_extra == {"extractor": 1, "inputs": ["int32[1, 32]"]}
    rms = next(r for r in prog.regions if r.name == "rmsnorm")
    assert (rms.deploy_variant, rms.measure_variant) == ("hopper", "hopper")
    assert rms.static_kwargs == {"eps": tcfg.norm_eps}
    cache = PlanCache(tmp_path / "plans.json")
    planner = AutoOffloader(PlannerConfig(max_measurements=3, reps=1,
                                          warmup=0))
    first = planner.plan(prog, cache=cache)
    assert first.baseline.ok and first.measurements
    assert first.loop_count == prog.source_loop_count == 3
    again = planner.plan(prog, cache=cache)
    assert again.from_cache and not again.measurements


def test_loop_extraction_launcher_on_the_cpu(capsys):
    from repro_torch.launch import loop_extraction
    out = loop_extraction.main(["--device", "cpu", "--reduced"])
    precision, recall, per_family = out["accuracy"][1:]
    assert precision == recall == 1.0
    assert set(per_family) == UNIVERSE and len(UNIVERSE) == 9
    assert all(s["tp"] >= 1 and s["precision"] == s["recall"] == 1.0
               for s in per_family.values())
    assert all(r["regions"] >= 2 and r["cached_replan"]
               for r in out["autoplan"])
    assert out["stitch"]["fused_key"] != out["stitch"]["split_key"]
    assert "micro_precision=1.000" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# rmsnorm: the plain version against the JAX kernel and oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,dtype", [
    ((4, 100, 512), "bfloat16"),
    ((8, 256), "float32"),
    ((2, 3, 5, 128), "float32"),
])
def test_rmsnorm_plain_matches_jax_kernel_and_ref(shape, dtype):
    rng = np.random.default_rng(5)
    xn = rng.standard_normal(shape).astype(np.float32)
    wn = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    jx = jnp.asarray(xn, dtype)
    want_kernel = np.asarray(jax_rmsnorm(jx, jnp.asarray(wn), interpret=True),
                             np.float32)
    want_ref = np.asarray(JR.rmsnorm_ref(jx, jnp.asarray(wn)), np.float32)
    x = torch.from_numpy(xn).to(getattr(torch, dtype))
    w = torch.from_numpy(wn)                 # float32 w with a bf16 x, as JAX
    got = rmsnorm_plain(x, w)
    assert got.dtype == x.dtype and got.shape == x.shape
    # the wrapper takes the plain version for a tensor on the CPU
    torch.testing.assert_close(RN.rmsnorm(x, w), got, rtol=0, atol=0)
    tol = NORM_TOL[dtype]
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)


def test_rmsnorm_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(4, 64)
    with pytest.raises(TypeError):
        RN.rmsnorm(x.half(), torch.zeros(64, dtype=torch.float16))
    with pytest.raises(ValueError):
        RN.rmsnorm(x, torch.zeros(32))
    with pytest.raises(ValueError):
        RN.rmsnorm(x, torch.zeros(64, device="meta"))
    assert RN.rmsnorm(torch.zeros(4, 64, device="meta"),
                      torch.zeros(64, device="meta")).is_meta
    assert RN.threads(300, 2) == 32 and RN.threads(5120, 2) == 160
    assert RN.threads(20000, 2) == 256 == RN.threads(5120, 4)


# ---------------------------------------------------------------------------
# Region.static_kwargs: plan-cache keys and Step 3
# ---------------------------------------------------------------------------
# The keys the code computed before Region.static_kwargs existed (the
# default PlannerConfig, backend "cpu"): annotated programs keep them.
ANNOTATED_KEYS = {
    "tdfir": ("tdfir:cpu:26d5e333c1c6c1410e70", "4a27ca17fe429476f8f0"),
    "mriq": ("mriq:cpu:3647656dea57e24c58b2", "063de52cf81c522da994"),
    "lm:mistral-nemo-12b": ("lm:mistral-nemo-12b:cpu:add93a29fd36d7dfcb3a",
                            "f5693fbfef83b5da0f17"),
}


def test_annotated_plan_cache_keys_unchanged_by_static_kwargs():
    progs = (T.make_program(device="cpu"), torch_mriq.make_program(device="cpu"),
             make_lm_program("mistral-nemo-12b", device="cpu"))
    for prog in progs:
        assert all(r.static_kwargs == {} for r in prog.regions)
        assert (plan_cache_key(prog, PlannerConfig(), "cpu"),
                measurement_cache_key(prog, "cpu")) == ANNOTATED_KEYS[prog.name]
        # a static kwarg re-keys both the plan and its measurements
        prog.regions[0].static_kwargs = {"window": 64}
        assert plan_cache_key(prog, PlannerConfig(), "cpu") != \
            ANNOTATED_KEYS[prog.name][0]
        assert measurement_cache_key(prog, "cpu") != ANNOTATED_KEYS[prog.name][1]


def test_static_kwargs_reach_the_variant_in_step_three():
    seen = {}

    @register_variant("rmsnorm", "probe")
    def probe(x, w, eps=1e-6, **kw):
        seen["eps"] = eps
        return rmsnorm_plain(x, w, eps)

    try:
        est = precompile("rmsnorm", "probe", probe,
                         (meta((4, 64), torch.float32), meta((64,), torch.float32)),
                         None, {"eps": 1e-5})
    finally:
        unregister_variant("rmsnorm", "probe")
    assert est.lower_ok and seen == {"eps": 1e-5}
    region = Region("rmsnorm", rmsnorm_plain, (), static_kwargs={"eps": 1e-5})
    assert region.static_kwargs == {"eps": 1e-5}


def test_region_call_pins_the_recorded_output_type():
    spec = ((2, 3), torch.bfloat16)
    got = E._coerce(torch.zeros(6), spec)
    assert tuple(got.shape) == (2, 3) and got.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# moe_dispatch: the capacity-bounded routed block
# ---------------------------------------------------------------------------
def _moe_args(dtype=torch.bfloat16):
    rng = np.random.default_rng(2)
    shapes = ((32, 16), (16, 4), (4, 16, 32), (4, 16, 32), (4, 32, 16))
    return tuple(torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
                 .to(dtype) for sh in shapes)


def _moe_dense(x, wr, wg, wu, wd):
    return MOE.moe_dispatch_dense(x, wr, wg, wu, wd, num_experts=4, k=2,
                                  capacity=8)


def test_torch_moe_dispatch_rediscovered():
    """The intent of JAX's ``test_moe_dispatch_rediscovered``: the dense
    dispatch with its static kwargs, standalone and in each layer of the
    reduced mixtral-8x7b (whose routed FFN is no ``mlp_core``), and the
    rebuilt program with the scatter-slot variant substituted."""
    args = _moe_args()
    report = E.extract(_moe_dense, args, name="moe")
    hits = _legal(report, "moe_dispatch")
    assert len(hits) == 1, report.summary()
    assert hits[0].static_kwargs == {"num_experts": 4, "k": 2, "capacity": 8}
    assert hits[0].arg_shapes() == ["bfloat16[32, 16]", "bfloat16[16, 4]",
                                    "bfloat16[4, 16, 32]",
                                    "bfloat16[4, 16, 32]",
                                    "bfloat16[4, 32, 16]"]
    assert [s.kind for s in report.sites] == ["route", "gate"]

    tcfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                               dtype="float32")
    jparams = JF.init_params(dataclasses.replace(
        jax_get_config("mixtral-8x7b").reduced(), dtype="float32"),
        jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    targs = (torch.from_numpy(_tokens(tcfg.vocab_size)),)

    def run(t, impl):
        return F.make_forward(tcfg, impl)(tparams, {"tokens": t})

    def tfn(t):
        return run(t, Impl())

    prog = E.discover(tfn, targs, name="mixtral")
    found = prog.extraction
    moe = _legal(found, "moe_dispatch")
    assert len(moe) == tcfg.num_layers, found.summary()
    assert {r.name for r in prog.regions} == {"attn_core", "moe_dispatch",
                                              "rmsnorm"}
    cap = MOE.moe_capacity(SEQ, tcfg.num_experts, tcfg.experts_per_token,
                           tcfg.capacity_factor)
    assert all(m.static_kwargs == {"num_experts": tcfg.num_experts,
                                   "k": tcfg.experts_per_token,
                                   "capacity": cap} for m in moe)
    ref = tfn(*targs)
    torch.testing.assert_close(prog.build(Impl())(*targs), ref, rtol=0,
                               atol=0)
    pattern = Impl({"moe_dispatch": "offload"})
    slots = prog.build(pattern)
    assert _region_calls(slots) == tcfg.num_layers
    # the substituted program is the model run under the same pattern
    sub = slots(*targs)
    torch.testing.assert_close(sub, run(*targs, pattern), rtol=0, atol=0)
    # and exact token-choice routing as ref is: their float32 rounding
    # differs, which a router's bf16 input may carry into a gate
    scale = float(ref.abs().max())
    assert float((sub - ref).abs().max()) / scale < SUB_RTOL


def test_torch_moe_unbounded_routing_rejected():
    """The intent of JAX's
    ``test_moe_unbounded_routing_rejected_with_diagnostic``: token-choice
    routing with no capacity bound is data-dependent (every routed token
    flows to its expert, so a queue has no static size); the recognizer
    walks the whole block and rejects it at the capacity gate."""
    def unbounded(x, wr, wg, wu, wd):
        probs = torch.softmax((x @ wr).float(), dim=-1)
        gate_vals, gate_idx = torch.topk(probs, 2)
        disp = (gate_idx[..., None] == torch.arange(4)).to(x.dtype)  # [T,k,E]
        comb = (disp * gate_vals[..., None].to(x.dtype)).sum(1)
        xe = torch.einsum("te,td->etd", disp.sum(1), x)           # no capacity
        h = Fn.silu(torch.einsum("etd,edf->etf", xe, wg)) * torch.einsum(
            "etd,edf->etf", xe, wu)
        ye = torch.einsum("etf,efd->etd", h, wd)
        return torch.einsum("etd,te->td", ye, comb)

    report = E.extract(unbounded, _moe_args(), name="moe_unbounded")
    assert not [m for m in report.matches if m.family == "moe_dispatch"]
    rejs = [r for r in report.rejections if r.family == "moe_dispatch"]
    assert rejs, report.summary()
    assert rejs[0].stage == "recognizer"
    assert rejs[0].primitive == "topk"
    assert "data-dependent" in rejs[0].reason
    assert "capacity" in rejs[0].reason
    assert rejs[0].reason in report.summary()


@pytest.mark.parametrize("which", ["slots", "expert_choice"])
def test_moe_scatter_combine_rejected(which):
    """A routed block that brings the experts' outputs back by a gather or
    a scatter (the slot dispatch, expert choice) has no dense combine
    product to bound: a recognizer rejection, no match."""
    def slots(x, wr, wg, wu, wd):
        return MOE.moe_dispatch_slots(x, wr, wg, wu, wd, num_experts=4, k=2,
                                      capacity=8)

    def expert_choice(x, wr, wg, wu, wd):
        return MOE.moe_expert_choice(
            x, {"router": wr, "w_gate": wg, "w_up": wu, "w_down": wd},
            num_experts=4, k=2, capacity_factor=1.25)

    fn = {"slots": slots, "expert_choice": expert_choice}[which]
    report = E.extract(fn, _moe_args(), name=which)
    assert not [m for m in report.matches if m.family == "moe_dispatch"]
    rejs = [r for r in report.rejections if r.family == "moe_dispatch"]
    assert len(rejs) == 1 and rejs[0].primitive == "sort", report.summary()
    assert "scatter/gather combine" in rejs[0].reason


def test_top_k_not_fed_by_a_router_is_no_site_of_moe():
    """A sort or top-k of anything but a router's softmax is left alone:
    no match and no rejection."""
    x = torch.zeros(16, 8)
    report = E.extract(lambda t: torch.topk(t.exp(), 2).values.sum()
                       + MOE.top_k(t, 3)[0].sum(), (x,), name="topk")
    assert not report.matches and not report.rejections


# ---------------------------------------------------------------------------
# mlp_gelu and conv_stem: whisper's blocks
# ---------------------------------------------------------------------------
def _gelu_mlp_args(dtype=torch.bfloat16):
    rng = np.random.default_rng(4)
    shapes = ((32, 64), (64, 128), (128,), (128, 64), (64,))
    return tuple(torch.from_numpy(rng.standard_normal(sh).astype(np.float32)
                                  * 0.3).to(dtype) for sh in shapes)


def test_gelu_mlp_rediscovered():
    """The intent of JAX's ``test_gelu_mlp_rediscovered``, for both the
    ``ref`` and the float32-accumulating ``offload`` forms; the JAX
    extractor's match on the same inputs has the same arguments."""
    args = _gelu_mlp_args()
    jreport = JE.extract(
        lambda x, wu, bu, wd, bd: jax.nn.gelu(x @ wu + bu) @ wd + bd,
        tuple(jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in args),
        name="gelu_mlp")
    for fn in (L.gelu_mlp, variants("mlp_gelu")["offload"]):
        report = E.extract(fn, args, name="gelu_mlp")
        hits = _legal(report, "mlp_gelu")
        assert len(hits) == 1, report.summary()
        x, wu, bu, wd, bd = hits[0].invars
        assert E._shape(wu) == (64, 128) and E._shape(bu) == (128,)
        assert E._shape(wd) == (128, 64) and E._shape(bd) == (64,)
        assert E._shape(x) == (32, 64)
        assert hits[0].arg_shapes() == _legal(jreport, "mlp_gelu")[0] \
            .arg_shapes()
    # the erf gelu is another function than the variants compute
    report = E.extract(lambda x, wu, bu, wd, bd: Fn.gelu(x @ wu + bu) @ wd
                       + bd, args, name="erf_gelu")
    assert not report.matches


def test_gelu_mlp_escaping_intermediate_rejected():
    """Returning the gelu activation alongside the MLP output makes a
    covered intermediate escape — recognized but never legal, and the
    report carries a structured legality rejection for it."""
    def leaky(x, wu, bu, wd, bd):
        g = Fn.gelu(x @ wu + bu, approximate="tanh")
        return g @ wd + bd, g

    report = E.extract(leaky, _gelu_mlp_args(), name="gelu_leak")
    matches = [m for m in report.matches if m.family == "mlp_gelu"]
    assert matches, report.summary()
    assert not matches[0].legal and "escapes" in matches[0].reason
    rejs = [r for r in report.rejections
            if r.family == "mlp_gelu" and r.stage == "legality"]
    assert rejs and rejs[0].reason == matches[0].reason


def _stem_args(dtype=torch.bfloat16):
    rng = np.random.default_rng(1)
    shapes = ((1, 64, 8), (3, 8, 16), (16,))
    return tuple(torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
                 .to(dtype) for sh in shapes)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_stem_rediscovered(stride):
    """The intent of JAX's ``test_conv_stem_rediscovered``: the stem's
    ``ref`` at stride 1 and 2 (the odd element of SAME's padding on the
    high side), with its stride a static kwarg and the arguments of JAX's
    match; the rebuilt program with ``offload`` substituted."""
    args = _stem_args()

    def stem(x, w, b):
        return variants("conv_stem")["ref"](x, w, b, stride=stride)

    report = E.extract(stem, args, name="stem")
    hits = _legal(report, "conv_stem")
    assert len(hits) == 1, report.summary()
    x, w, b = hits[0].invars
    assert E._shape(x) == (1, 64, 8)
    assert E._shape(w) == (3, 8, 16) and E._shape(b) == (16,)
    assert hits[0].static_kwargs == {"stride": stride}
    jreport = JE.extract(
        lambda x, w, b: jax.nn.gelu(jax.lax.conv_general_dilated(
            x, w, window_strides=(stride,), padding="SAME",
            dimension_numbers=("NHC", "HIO", "NHC")) + b),
        tuple(jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in args),
        name="stem")
    jhit = _legal(jreport, "conv_stem")[0]
    assert hits[0].arg_shapes() == jhit.arg_shapes()
    assert jhit.static_kwargs == hits[0].static_kwargs
    prog = E.discover(stem, args, name="stem")
    ref = stem(*args).float()
    torch.testing.assert_close(prog.build(Impl())(*args).float(), ref,
                               rtol=0, atol=0)
    sub = prog.build(Impl({"conv_stem": "offload"}))
    assert _region_calls(sub) == 1
    scale = float(ref.abs().max())
    assert float((sub(*args).float() - ref).abs().max()) / scale < SUB_RTOL


def test_dilated_conv_rejected_with_diagnostic():
    """A dilated conv is recognized as a near-miss, not silently skipped:
    the report carries a structured Rejection naming the op and the
    dilation that disqualified it.  A 2-D conv and a grouped one are
    rejected with their own diagnostics."""
    x, w, b = _stem_args()

    def dilated(x, w, b):
        y = Fn.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), padding=2,
                      dilation=2)
        return Fn.gelu(y.transpose(1, 2) + b, approximate="tanh")

    report = E.extract(dilated, (x, w, b), name="stem_dilated")
    assert not [m for m in report.matches if m.family == "conv_stem"]
    rejs = [r for r in report.rejections if r.family == "conv_stem"]
    assert len(rejs) == 1, report.summary()
    assert rejs[0].stage == "recognizer"
    assert rejs[0].primitive == "convolution"
    assert "dilat" in rejs[0].reason
    assert rejs[0].reason in report.summary()

    def conv2d(x, w, b):
        y = Fn.conv2d(x.transpose(1, 2)[..., None], w.permute(2, 1, 0)[
            ..., None], padding=(1, 0))
        return Fn.gelu(y[..., 0].transpose(1, 2) + b, approximate="tanh")

    def grouped(x, w, b):
        y = Fn.conv1d(x.transpose(1, 2), w.permute(2, 1, 0)[:, :4],
                      padding=1, groups=2)
        return Fn.gelu(y.transpose(1, 2) + b, approximate="tanh")

    for fn, why in ((conv2d, "only 1-D"), (grouped, "grouped")):
        report = E.extract(fn, (x, w, b), name=fn.__name__)
        assert not report.matches, report.summary()
        rejs = [r for r in report.rejections if r.family == "conv_stem"]
        assert len(rejs) == 1 and why in rejs[0].reason, report.summary()


def test_discovered_whisper_rebuilds_and_substitutes():
    """Unannotated reduced whisper-small (its frames closed over): the
    stem's two convolutions, the encoder's and the decoder's gelu MLPs are
    found; the rebuilt program equals the captured one; with ``offload``
    substituted for both families it stays within the substitution
    tolerance of the JAX all-ref forward."""
    jcfg, jfn, jargs, tcfg, tfn, targs = _pair("whisper-small")
    prog = E.discover(tfn, targs, name="whisper")
    found = prog.extraction
    assert len(_legal(found, "conv_stem")) == 2
    assert len(_legal(found, "mlp_gelu")) == (tcfg.encoder_layers
                                              + tcfg.num_layers)
    assert sorted(m.static_kwargs["stride"]
                  for m in _legal(found, "conv_stem")) == [1, 2]
    assert {"attn_core", "conv_stem", "mlp_gelu", "rmsnorm"} <= {
        r.name for r in prog.regions}
    torch.testing.assert_close(prog.build(Impl())(*targs), tfn(*targs),
                               rtol=0, atol=0)
    ref = np.asarray(jfn(*jargs), np.float32)
    mixed = prog.build(Impl({"mlp_gelu": "offload", "conv_stem": "offload"}))
    assert _region_calls(mixed) == 2 + tcfg.encoder_layers + tcfg.num_layers
    sub = mixed(*targs).numpy()
    scale = float(np.max(np.abs(ref))) + 1e-9
    assert float(np.max(np.abs(ref - sub))) / scale < SUB_RTOL
