"""The port's roofline surrogate (``core/cost_model.py``) against the JAX
package's, on the same candidates and the same observation sequence.

With the port's seed constants set to the JAX values the two models are the
same arithmetic: predictions agree to 1e-12 relative after every
observation — bare genes, tile genes of ``fir_bank`` (whose tuning space
is the same in both packages: ``pallas`` in JAX, ``hopper`` in the port),
pair-bias folding, and ``export_state``/``load_state`` round trips.  With
the port's own H100 seeds only the seeds differ: once every gene has one
observation the predictions agree again.
"""
import itertools
from dataclasses import dataclass

import pytest

import repro.apps.tdfir  # noqa: F401 (registers fir_bank=pallas + tuning)
import repro_torch.apps.tdfir  # noqa: F401 (registers fir_bank=hopper)
from repro.core import cost_model as JCM
from repro_torch.core import cost_model as TCM

REL = 1e-12
TILE = ("block_n", "tap_unroll")


@dataclass(frozen=True)
class Cand:
    region: str
    variant: str
    resource_fraction: float
    flops: float
    transcendentals: float
    boundary_bytes: float
    alignment: float = 1.0


# (region, variant, fraction, flops, transcendentals, bytes, alignment)
ROWS = [("fir_bank", "hopper", 0.3, 2.1e9, 0.0, 4.2e6, 1.0),
        ("fir_bank", "offload", 0.04, 2.1e9, 0.0, 4.2e6, 1.0),
        ("fir_load", "offload", 0.02, 3.3e5, 0.0, 2.1e6, 0.5),
        ("fir_energy", "offload", 0.01, 6.5e5, 1.6e5, 2.1e6, 1.0),
        ("compute_q", "hopper", 0.07, 1.1e11, 2.1e10, 3.4e5, 1.0)]


def _cands(pkg):
    return [Cand(r, "pallas" if pkg == "jax" and v == "hopper" else v, *rest)
            for r, v, *rest in ROWS]


def _jname(impl: dict) -> dict:
    out = {}
    for r, v in impl.items():
        if isinstance(v, tuple):
            out[r] = ("pallas" if v[0] == "hopper" else v[0], v[1])
        else:
            out[r] = "pallas" if v == "hopper" else v
    return out


def _tile(bn, tu):
    return ("hopper", {"block_n": bn, "tap_unroll": tu})


# a fixed observation sequence: all-ref, single genes, tile genes, and
# composites repeated so the pair-bias streak (3) folds a correction
PATTERNS = ([{}, {"fir_bank": "hopper"}, {"fir_load": "offload"},
             {"fir_bank": _tile(256, 4)}, {"compute_q": "hopper"}]
            + [{"fir_bank": "hopper", "fir_energy": "offload"}] * 4
            + [{"fir_bank": _tile(1024, 8), "fir_load": "offload",
                "fir_energy": "offload"}] * 3
            + [{"fir_bank": "offload", "compute_q": "hopper"}])


def _measured(i: int, impl: dict) -> float:
    """A deterministic, non-additive 'measurement'."""
    return 1e-3 * (1.0 + 0.37 * len(impl) + 0.11 * i) * (
        1.3 if len(impl) >= 2 else 1.0)


QUERIES = [{}, {"fir_bank": "hopper"}, {"fir_bank": _tile(128, 2)},
           {"fir_bank": _tile(1024, 8), "fir_energy": "offload"},
           {"fir_bank": "hopper", "fir_energy": "offload"},
           {"fir_load": "offload", "fir_energy": "offload",
            "compute_q": "hopper"},
           {"fir_bank": "offload", "fir_load": "offload"}]


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)


def _jax_seeds(monkeypatch):
    for name in ("ACCEL_FLOPS", "ACCEL_BW", "ACCEL_TRANSCENDENTAL_RATE"):
        monkeypatch.setattr(TCM, name, getattr(JCM, name))
    monkeypatch.setattr(TCM, "SMEM_KNEE", JCM.VMEM_KNEE)
    monkeypatch.setattr(TCM, "SMEM_PRESSURE", JCM.VMEM_PRESSURE)


@pytest.mark.parametrize("baseline", [0.0, 2e-3])
def test_same_predictions_as_jax_with_the_jax_seeds(monkeypatch, baseline):
    _jax_seeds(monkeypatch)
    jm = JCM.CostModel(candidates=_cands("jax"), baseline_seconds=baseline)
    tm = TCM.CostModel(candidates=_cands("torch"), baseline_seconds=baseline)
    for q in QUERIES:
        assert _close(tm.predict(q), jm.predict(_jname(q)))
    for i, impl in enumerate(PATTERNS):
        s = _measured(i, impl)
        jm.observe(_jname(impl), s)
        tm.observe(impl, s)
        for q in QUERIES:
            assert _close(tm.predict(q), jm.predict(_jname(q))), (i, q)
    # the pair-bias fold fired on both, with the same correction
    jnotes, tnotes = jm.bias_notes(), tm.bias_notes()
    assert tnotes and len(tnotes) == len(jnotes)
    for a, b in zip(tnotes, jnotes):
        assert [[r, v.replace("hopper", "pallas")] for r, v in a["pair"]] \
            == b["pair"]
        assert a["sign"] == b["sign"] and _close(a["corrected_seconds"],
                                                 b["corrected_seconds"])
    assert _close(tm.mean_abs_rel_error(), jm.mean_abs_rel_error())
    # export/load round trip: a fresh model restored from the snapshot
    # predicts as the calibrated one, in both packages
    state = tm.export_state()
    again = TCM.CostModel(candidates=_cands("torch"))
    assert again.load_state(state)
    jagain = JCM.CostModel(candidates=_cands("jax"))
    assert jagain.load_state(jm.export_state())
    for q in QUERIES:
        assert _close(again.predict(q), tm.predict(q))
        assert _close(again.predict(q), jagain.predict(_jname(q)))
    assert not again.load_state({}) and not again.load_state("junk")


def test_hopper_seeds_differ_only_until_every_gene_is_observed():
    jm = JCM.CostModel(candidates=_cands("jax"))
    tm = TCM.CostModel(candidates=_cands("torch"))
    # the seeds are the H100's, not the TPU's: uncalibrated predictions
    # of an offloaded gene differ
    assert not _close(tm.predict({"compute_q": "hopper"}),
                      jm.predict({"compute_q": "pallas"}))
    genes = [{}] + [{r: v} for r, v, *_ in ROWS] + [
        {"fir_bank": _tile(128, 2)}, {"fir_bank": _tile(1024, 8)}]
    for i, impl in enumerate(genes):
        s = _measured(i, impl)
        jm.observe(_jname(impl), s)
        tm.observe(impl, s)
    regions = sorted({r for r, *_ in ROWS})
    for combo in itertools.product(*(["ref"] + [v for r2, v, *_ in ROWS
                                                if r2 == r]
                                     for r in regions)):
        q = {r: v for r, v in zip(regions, combo) if v != "ref"}
        assert _close(tm.predict(q), jm.predict(_jname(q))), q
    for q in QUERIES:
        assert _close(tm.predict(q), jm.predict(_jname(q))), q


def test_hopper_seed_constants_are_the_h100s():
    assert TCM.ACCEL_FLOPS == 989e12 and TCM.ACCEL_BW == 3.35e12
    assert TCM.ACCEL_TRANSCENDENTAL_RATE == pytest.approx(67e12 / 16,
                                                          rel=1e-3)
    # never negative, and a NaN or inf measurement is ignored
    tm = TCM.CostModel(candidates=_cands("torch"), baseline_seconds=1e-3)
    tm.observe({"fir_bank": "hopper"}, float("nan"))
    tm.observe({"fir_bank": "hopper"}, float("inf"))
    assert tm.history == []
    tm.observe({"fir_bank": "hopper"}, -5.0)
    assert tm.predict({"fir_bank": "hopper"}) > 0
