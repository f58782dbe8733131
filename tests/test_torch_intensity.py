"""Steps 1 and 2 of the port against the JAX package's jaxpr walker, on
both paper apps at the paper-size analysis arguments.

Flop counts: the JAX walker also counts the scalar index arithmetic of its
traced loops — per trip, the loop counter's ``add`` and, for every traced
scalar index, the ``lt``/``add``/``select_n`` that normalise a negative
index (plus ``fir_bank``'s ``K-1-j`` subtraction).  The port indexes with
Python ints, which cost no op.  So a region's two counts differ by at most
16 flops per loop trip (MRI-Q's ``compute_q`` and ``mriq_phimag`` read five
and four traced indexes per trip), and the hot loops (``fir_bank``,
``compute_q``) agree to 1e-4 relative.  Transcendentals and boundary bytes
are exact.  JAX reports the ``jnp.pad`` of ``fir_bank`` as an unclassified
``jit``; the port's ``constant_pad_nd`` is classified, so its list is
empty."""
import time

import jax
import numpy as np
import pytest
import torch

from repro.apps import mriq as jax_mriq
from repro.apps import tdfir as jax_tdfir
from repro.core import intensity as JI
from repro_torch.apps import mriq as torch_mriq
from repro_torch.apps import tdfir as torch_tdfir
from repro_torch.core import intensity as TI
from repro_torch.core.loops import fori_loop, observe_loops
from repro_torch.core.regions import Impl

INDEX_FLOPS_PER_TRIP = 16
HOT_RTOL = 1e-4
APPS = {"tdfir": (jax_tdfir, torch_tdfir, 4), "mriq": (jax_mriq, torch_mriq, 3)}


@pytest.fixture(scope="module")
def analyses():
    out = {}
    for name, (jmod, tmod, _) in APPS.items():
        jprog, tprog = jmod.make_program(), tmod.make_program(device="cpu")
        out[name] = (
            {r.name: JI.analyze_region(r.analysis_fn, *r.analysis_args,
                                       name=r.name) for r in jprog.regions},
            {r.name: TI.analyze_region(r.analysis_fn, *r.analysis_args,
                                       name=r.name) for r in tprog.regions})
    return out


@pytest.mark.parametrize("app", sorted(APPS))
def test_loop_census_matches_jax(app):
    jmod, tmod, loops = APPS[app]
    tprog = tmod.make_program(device="cpu")
    sample = tprog.sample_inputs(0, tprog.device)
    assert TI.count_loops(tprog.build(Impl()), *sample) == loops
    jprog = jmod.make_program()
    jsample = jprog.sample_inputs(jax.random.PRNGKey(0))
    from repro.core.regions import Impl as JImpl
    assert JI.count_loops(jprog.build(JImpl()), *jsample) == loops


@pytest.mark.parametrize("app", sorted(APPS))
def test_step2_ranking_matches_jax(analyses, app):
    jana, tana = analyses[app]

    def order(ana):
        return [n for n, _ in sorted(ana.items(),
                                     key=lambda kv: -kv[1].arithmetic_intensity)]

    assert order(tana) == order(jana)


@pytest.mark.parametrize("app", sorted(APPS))
def test_counts_match_jax(analyses, app):
    jana, tana = analyses[app]
    assert tana.keys() == jana.keys()
    for name, j in jana.items():
        t = tana[name]
        assert t.boundary_bytes == j.boundary_bytes, name
        assert t.transcendentals == j.transcendentals, name
        assert t.loop_count == j.loop_count == 1, name
        assert t.max_trip == j.max_trip, name
        assert t.alignment == j.alignment, name
        assert t.unclassified == {}, name
        assert 0 <= j.flops - t.flops <= INDEX_FLOPS_PER_TRIP * j.max_trip, name
        if name in ("fir_bank", "compute_q"):
            assert t.flops == pytest.approx(j.flops, rel=HOT_RTOL), name
            assert t.arithmetic_intensity == pytest.approx(
                j.arithmetic_intensity, rel=HOT_RTOL), name


def test_paper_numbers():
    """The table the port is held to (JAX package, paper-size args)."""
    tprog = torch_mriq.make_program(device="cpu")
    q = TI.analyze_region(tprog.regions[1].analysis_fn,
                          *tprog.regions[1].analysis_args)
    assert q.flops == 10 * 262_144 * 2048
    assert q.transcendentals == 2 * 262_144 * 2048
    assert q.boundary_bytes == 5_275_648
    assert q.arithmetic_intensity == pytest.approx(2646, rel=1e-3)


def test_full_size_analysis_runs_each_loop_body_once():
    calls = []

    def body(i, acc):
        calls.append(i)
        return acc + 1

    with observe_loops(TI.OpCounter(TI.RegionAnalysis())):
        fori_loop(3, 262_147, body, torch.zeros((), device="meta"))
    assert calls == [3]
    assert fori_loop(0, 4, lambda i, a: a + i, 0) == 6     # plain Python loop

    TI.analyze_region(lambda x: x + 1, torch.zeros(4))     # warm the mode
    t0 = time.perf_counter()
    for tmod in (torch_tdfir, torch_mriq):
        prog = tmod.make_program(device="cpu")
        for r in prog.regions:
            TI.analyze_region(r.analysis_fn, *r.analysis_args)
    assert time.perf_counter() - t0 < 5.0


def test_analysis_never_executes_on_real_tensors():
    x = torch.ones(8, 128)
    seen = []

    def fn(a):
        seen.append(a.device.type)
        return a * 2

    ana = TI.analyze_region(fn, x)
    assert seen == ["meta"]
    assert ana.flops == 8 * 128 and ana.boundary_bytes == 2 * x.numel() * 4
    assert np.all(x.numpy() == 1)


def test_nested_loops_multiply_trip_counts():
    def fn(a):
        def outer(i, acc):
            return fori_loop(0, 5, lambda j, b: b * 2, acc)
        return fori_loop(0, 3, outer, a)

    ana = TI.analyze_region(fn, torch.empty(128, device="meta"))
    assert ana.loop_count == 2
    assert ana.max_trip == 15
    assert ana.flops == 15 * 128
