"""The port's genetic and surrogate strategies against the JAX package's:
the same Step-3 candidate list (same ranked order, same numbers, ``pallas``
renamed ``hopper``), the same scripted measurement table and the same seed
give the same proposal sequence, the same measurements spent and the same
winner.

The lists are shared rather than planned by each package: the GA's alleles
follow the ranked order (``_tile_alleles``), and the port's Step-3 numbers
are its own.  For the surrogate both cost models take the JAX seed
constants (tests/test_torch_cost_model.py holds the two models equal under
them).  The surrogate breaks ties in predicted time by the pattern's name
(predictions clamped at their floor tie), and ``pallas`` and ``hopper``
sort differently against ``offload``: so the JAX registry gets each
region's Pallas variant, with its tuning space, under the name ``hopper``
for these tests, and both packages search the same names.
``tune_tiles`` on binds tuning spaces that are the same in both packages:
tdFIR's ``fir_bank`` tile knobs, and for the LM case a probe variant of
``mlp_core`` registered with one space in both registries.
"""
import pytest

import repro.apps.mriq  # noqa: F401 (registers the JAX variants)
import repro.apps.tdfir  # noqa: F401
import repro_torch.apps.mriq  # noqa: F401 (registers the port's)
import repro_torch.apps.tdfir  # noqa: F401
from repro.apps import tdfir as jax_tdfir
from repro.core import cost_model as JCM
from repro.core import regions as JR
from repro.core import search as JS
from repro.core import strategies as JSTRAT
from repro_torch.apps import tdfir as torch_tdfir
from repro_torch.core import cost_model as TCM
from repro_torch.core import regions as TR
from repro_torch.core import search as TS
from repro_torch.core import strategies as TSTRAT
from repro_torch.core.planner import PlannerConfig

# (region, variant, fraction, efficiency, flops, transcendentals, bytes)
CASES = {
    "tdfir": [("fir_bank", "hopper", 0.0264, 596.8, 2.1e9, 0.0, 4.2e6),
              ("fir_bank", "offload", 0.041, 384.0, 2.1e9, 0.0, 4.2e6),
              ("fir_energy", "offload", 0.02, 25.0, 6.5e5, 1.6e5, 2.1e6),
              ("fir_load", "offload", 0.04, 7.8, 3.3e5, 0.0, 2.1e6)],
    "mriq": [("compute_q", "hopper", 0.0705, 37538.2, 1.1e11, 2.1e10, 3.4e5),
             ("compute_q", "offload", 0.3, 9000.0, 1.1e11, 2.1e10, 3.4e5),
             ("mriq_phimag", "offload", 0.0002, 1600.0, 6.5e3, 0.0, 4.0e4),
             ("mriq_check", "offload", 0.02, 25.0, 6.5e5, 0.0, 2.6e5)],
    "lm": [("attn_core", "hopper", 0.45, 2100.0, 6.9e10, 8.4e6, 3.3e7),
           ("attn_core", "offload", 0.2, 1500.0, 6.9e10, 8.4e6, 3.3e7),
           ("rglru_scan", "hopper", 0.1, 320.0, 2.1e7, 0.0, 6.3e7),
           ("rglru_scan", "offload", 0.05, 250.0, 2.1e7, 0.0, 6.3e7),
           ("rglru_scan", "seq", 0.05, 240.0, 2.1e7, 0.0, 6.3e7),
           ("mlp_core", "offload", 0.33, 900.0, 1.9e11, 0.0, 9.4e7),
           ("mlp_core", "tiled_probe", 0.4, 880.0, 1.9e11, 0.0, 9.4e7)],
}
PROBE_SPACE = {"axes": {"block": (64, 128, 256)}, "defaults": {"block": 128}}
SEEDS = (0, 1, 2, 3)


RENAMED = ("fir_bank", "compute_q", "attn_core", "rglru_scan")


@pytest.fixture(scope="module", autouse=True)
def _shared_names():
    """``mlp_core=tiled_probe`` with one tuning space in both registries,
    and the JAX package's Pallas variants also under the name ``hopper``."""
    import repro.kernels.ops  # noqa: F401 (the JAX attn/rglru variants)
    for mod in (JR, TR):
        mod.register_variant("mlp_core", "tiled_probe",
                             tuning=mod.TuningSpace(**PROBE_SPACE))(
            lambda *a, **k: None)
    for region in RENAMED:
        JR.register_variant(region, "hopper",
                            tuning=JR.tuning_space(region, "pallas"))(
            JR.variants(region)["pallas"])
    yield
    for mod in (JR, TR):
        mod.unregister_variant("mlp_core", "tiled_probe")
    for region in RENAMED:
        JR.unregister_variant(region, "hopper")


def _stub_seconds(pattern: str, base_s: float) -> float:
    """Deterministic run time of a pattern, fastest with a kernel."""
    if pattern == "all-ref":
        return base_s
    bonus = 0.05 if "=hopper" in pattern else 0.0
    return 0.1 + (sum(ord(c) for c in pattern) % 97) / 1000.0 - bonus


def _tuning(pkg: str, region: str, variant: str):
    regions = JR if pkg == "jax" else TR
    if region == "fir_bank" and variant == "hopper":
        if pkg == "jax":
            args = jax_tdfir.make_program().regions[1].analysis_args
            space = JR.tuning_space("fir_bank", "hopper")
        else:
            args = torch_tdfir.make_program(device="cpu").regions[1].analysis_args
            space = TR.tuning_space("fir_bank", "hopper")
        return regions.BoundTuningSpace(space, args)
    if variant == "tiled_probe":
        return regions.BoundTuningSpace(
            regions.tuning_space("mlp_core", "tiled_probe"), ())
    return None


def _run(pkg: str, case: str, strategy: str, seed: int, tune: bool,
         budget: int, monkeypatch):
    regions_mod, search_mod, strat_mod, cm_mod = (
        (JR, JS, JSTRAT, JCM) if pkg == "jax" else (TR, TS, TSTRAT, TCM))
    if pkg == "torch":                  # the JAX seeds, for the surrogate
        for name in ("ACCEL_FLOPS", "ACCEL_BW", "ACCEL_TRANSCENDENTAL_RATE"):
            monkeypatch.setattr(TCM, name, getattr(JCM, name))
        monkeypatch.setattr(TCM, "SMEM_KNEE", JCM.VMEM_KNEE)
        monkeypatch.setattr(TCM, "SMEM_PRESSURE", JCM.VMEM_PRESSURE)

    ranked = [strat_mod.SearchCandidate(
        r, v, frac, eff, flops=fl, transcendentals=tr,
        boundary_bytes=by, tuning=_tuning(pkg, r, v) if tune else None)
        for r, v, frac, eff, fl, tr, by in CASES[case]]
    regions = list(dict.fromkeys(r for r, *_ in CASES[case]))
    base_s = 0.15
    base = search_mod.Measurement("all-ref", 0.0, base_s, [base_s], impl={})
    state = strat_mod.SearchState(regions=regions, ranked=ranked,
                                  resource_cap=1.0, seed=seed, baseline=base)
    model = cm_mod.CostModel(candidates=ranked, baseline_seconds=base_s)
    model.observe(regions_mod.Impl(), base_s)
    state.cost_model = model

    def measure(impl):
        pattern = regions_mod.Impl(impl).describe()
        s = _stub_seconds(pattern, base_s)
        return search_mod.Measurement(pattern, 0.0, s, [s], impl=dict(impl))

    ledger = search_mod.MeasurementLedger(measure, budget=budget)
    ledger.prime(regions_mod.Impl(), base)
    cfg = PlannerConfig(strategy=strategy, seed=seed,
                        max_measurements=budget)
    strat = strat_mod.make_strategy(cfg)
    strat.run(state, ledger)
    best = min((m for m in ledger.served if m.ok and m.mapping()),
               key=lambda m: m.run_seconds, default=None)
    trace = [(t["stage"], list(t["patterns"]),
              [(g["pattern"], g["source"], g["measured"])
               for g in t.get("genomes", [])])
             for t in state.trace]
    return {"proposals": [m.pattern for m in ledger.order],
            "spent": ledger.misses,
            "winner": best.pattern if best else None,
            "trace": trace, "skipped": list(state.skipped),
            "history": [(h["pattern"], h["measured"]) for h in model.history]}


@pytest.mark.parametrize("budget", [4, 8])
@pytest.mark.parametrize("tune", [False, True], ids=["tiles_off", "tiles_on"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("strategy", ["genetic", "surrogate"])
def test_ga_and_surrogate_propose_the_jax_sequence(monkeypatch, strategy,
                                                   case, tune, budget):
    for seed in SEEDS:
        want = _run("jax", case, strategy, seed, tune, budget, monkeypatch)
        got = _run("torch", case, strategy, seed, tune, budget, monkeypatch)
        assert got == want, seed
        assert 0 < got["spent"] <= budget
        assert len(set(got["proposals"])) == len(got["proposals"])
        if strategy == "surrogate":        # never the whole budget
            assert got["spent"] <= max(1, budget - 1)


def test_surrogate_spends_fewer_than_genetic_on_every_case(monkeypatch):
    for case in CASES:
        ga = _run("torch", case, "genetic", 0, False, 4, monkeypatch)
        sur = _run("torch", case, "surrogate", 0, False, 4, monkeypatch)
        assert sur["spent"] < ga["spent"] == 4, case


def test_make_strategy_builds_every_strategy():
    for name in ("genetic", "surrogate"):
        strat = TSTRAT.make_strategy(PlannerConfig(strategy=name,
                                                   ga_population=9))
        assert strat.name == name and strat.population == 9
        assert strat.surrogate == (name == "surrogate")
    auto = PlannerConfig(strategy="auto", max_measurements=4)
    assert TSTRAT.make_strategy(auto, space_size=100).name == "surrogate"
    assert TSTRAT.make_strategy(auto, space_size=17).name == "surrogate"
    assert TSTRAT.make_strategy(auto, space_size=16).name == "staged"
    assert TSTRAT.make_strategy(auto, space_size=4).name == "exhaustive"
    assert TSTRAT.make_strategy(auto).name == "staged"
    with pytest.raises(ValueError):
        TSTRAT.make_strategy(PlannerConfig(strategy="annealing"))
