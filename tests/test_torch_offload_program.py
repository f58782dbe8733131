"""The port's planner programs for the LM path against the JAX package's:
``make_lm_program`` (block regions of an arch) and the decode-attention
program of ``benchmarks/autotune.py``; and CPU plans over both.

Timings on this shared CPU decide nothing here: the tests hold the
structure (regions, signatures, keys, measurement counts, cache hits),
never which pattern wins."""
import jax
import numpy as np
import pytest

from benchmarks.autotune import make_decode_program as jax_decode_program
from repro.core.intensity import analyze_region as jax_analyze
from repro.models.offload_program import make_lm_program as jax_lm_program
from repro_torch.apps.decode_attn import make_decode_program
from repro_torch.core.intensity import analyze_region
from repro_torch.core.plan_cache import (PlanCache, measurement_cache_key,
                                         plan_cache_key)
from repro_torch.core.planner import AutoOffloader, PlannerConfig
from repro_torch.core.regions import tuning_space
from repro_torch.models.offload_program import make_lm_program

ARCH = "mistral-nemo-12b"


@pytest.fixture(scope="module")
def programs():
    return jax_lm_program(ARCH), make_lm_program(ARCH, device="cpu")


def test_lm_program_regions_and_signatures_match_jax(programs):
    jprog, tprog = programs
    assert tprog.name == jprog.name == f"lm:{ARCH}"
    assert [r.name for r in tprog.regions] == [r.name for r in jprog.regions]
    assert ([r.arg_signature() for r in tprog.regions]
            == [r.arg_signature() for r in jprog.regions])
    assert tprog.regions[0].arg_signature()[0] == "bfloat16[1,32,4096,128]"
    assert ([r.deploy_variant for r in tprog.regions]
            == ["hopper", "offload"])          # JAX: "pallas", "offload"
    assert [r.deploy_variant for r in jprog.regions] == ["pallas", "offload"]
    assert tprog.cache_extra == jprog.cache_extra == {"batch": 2, "seq": 128}
    assert tprog.source_loop_count == jprog.source_loop_count == 40


def test_lm_program_step2_ranks_regions_as_jax_does(programs):
    jprog, tprog = programs

    def order(prog, analyze):
        ai = {r.name: analyze(r.analysis_fn, *r.analysis_args,
                              name=r.name).arithmetic_intensity
              for r in prog.regions}
        return sorted(ai, key=lambda n: -ai[n])

    assert order(tprog, analyze_region) == order(jprog, jax_analyze)


def test_lm_program_keys_carry_the_measurement_conditions():
    cfg = PlannerConfig()
    a = make_lm_program(ARCH, device="cpu")
    b = make_lm_program(ARCH, seq=64, device="cpu")
    assert plan_cache_key(a, cfg, "cpu") != plan_cache_key(b, cfg, "cpu")
    assert measurement_cache_key(a, "cpu") != measurement_cache_key(b, "cpu")
    same = make_lm_program(ARCH, device="cpu")
    assert plan_cache_key(a, cfg, "cpu") == plan_cache_key(same, cfg, "cpu")


def test_cpu_plan_of_the_lm_program_completes_then_hits(tmp_path):
    prog = make_lm_program(ARCH, seq=32, device="cpu")
    cfg = PlannerConfig(reps=2)
    cache = PlanCache(tmp_path / "plans.json")
    report = AutoOffloader(cfg).plan(prog, cache=cache)
    assert report.baseline.ok
    assert report.ai_selected == ["mlp_core", "attn_core"]
    # the fused MLP's [4096, 28672] intermediate is over the L2: only the
    # flash kernel survives Step 3
    assert report.eff_pairs == [("attn_core", "hopper")]
    assert [m.mapping() for m in report.measurements] == [
        {"attn_core": "hopper"}]
    assert all(m.ok for m in report.measurements)
    assert report.loop_count >= 3        # layers, query chunks, key chunks
    again = AutoOffloader(cfg).plan(prog, cache=cache)
    assert again.from_cache and not again.measurements
    assert again.best_pattern == report.best_pattern


def test_decode_program_matches_jax_and_plans(tmp_path):
    jprog = jax_decode_program()
    tprog = make_decode_program(device="cpu")
    assert ([r.arg_signature() for r in tprog.regions]
            == [r.arg_signature() for r in jprog.regions])
    assert tprog.regions[0].measure_variant == "hopper"
    sample = tprog.sample_inputs(0, tprog.device)
    jsample = jprog.sample_inputs(jax.random.PRNGKey(0))
    assert [tuple(t.shape) for t in sample] == [a.shape for a in jsample]
    np.testing.assert_array_equal(sample[3].numpy(), np.asarray(jsample[3]))
    np.testing.assert_array_equal(sample[4].numpy(), np.asarray(jsample[4]))
    cfg = PlannerConfig(reps=2)
    cache = PlanCache(tmp_path / "plans.json")
    report = AutoOffloader(cfg).plan(tprog, cache=cache)
    assert report.baseline.ok
    assert [m.mapping() for m in report.measurements] == [
        {"decode_attn": "hopper"}]
    again = AutoOffloader(cfg).plan(tprog, cache=cache)
    assert again.from_cache and not again.measurements


def test_decode_program_tuned_plan_measures_every_fitting_tile(tmp_path):
    prog = make_decode_program(device="cpu")
    cfg = PlannerConfig(reps=1, strategy="exhaustive", tune_tiles=True,
                        max_measurements=8)
    report = AutoOffloader(cfg).plan(prog, cache=PlanCache(tmp_path / "p.json"))
    seen = sorted(str(m.mapping()["decode_attn"]) for m in report.measurements)
    # float32 at head_dim 64: block_k 64 and 128 fit two stages of k and v
    # tiles in shared memory, 256 (256 KB) does not
    fitting = tuning_space("decode_attn", "hopper").size(
        prog.regions[0].analysis_args)
    assert fitting == 2
    assert len(seen) == fitting and report.search_space == fitting


# ---------------------------------------------------------------------------
# the recurrent archs: falcon-mamba-7b (ssm_scan), recurrentgemma-2b
# (attn_core at head_dim 256, mlp_core, rglru_scan)
# ---------------------------------------------------------------------------
RECURRENT_REGIONS = {
    "falcon-mamba-7b": (["ssm_scan"], ["hopper"], ["seq"]),
    "recurrentgemma-2b": (["attn_core", "mlp_core", "rglru_scan"],
                          ["hopper", "offload", "hopper"],
                          ["offload", "offload", "offload"]),
}


@pytest.fixture(scope="module", params=sorted(RECURRENT_REGIONS))
def recurrent_programs(request):
    arch = request.param
    return arch, jax_lm_program(arch), make_lm_program(arch, device="cpu")


def test_recurrent_lm_programs_match_jax(recurrent_programs):
    arch, jprog, tprog = recurrent_programs
    names, deploy, measure = RECURRENT_REGIONS[arch]
    assert tprog.name == jprog.name == f"lm:{arch}"
    assert [r.name for r in tprog.regions] == [r.name for r in jprog.regions]
    assert [r.name for r in tprog.regions] == names
    assert ([r.arg_signature() for r in tprog.regions]
            == [r.arg_signature() for r in jprog.regions])
    assert [r.deploy_variant for r in tprog.regions] == deploy
    assert [r.measure_variant for r in tprog.regions] == measure
    assert ([r.measure_variant for r in jprog.regions] == measure)
    assert tprog.cache_extra == jprog.cache_extra
    assert tprog.source_loop_count == jprog.source_loop_count
    # the JAX variants of each region, with pallas -> hopper
    from repro.core.regions import variants as jax_variants
    from repro_torch.core.regions import variants
    for r in tprog.regions:
        want = {"hopper" if v == "pallas" else v for v in jax_variants(r.name)}
        assert set(variants(r.name)) == want, r.name


def test_recurrent_lm_program_step2_ranks_regions_as_jax_does(
        recurrent_programs):
    _, jprog, tprog = recurrent_programs

    def order(prog, analyze):
        ai = {r.name: analyze(r.analysis_fn, *r.analysis_args,
                              name=r.name).arithmetic_intensity
              for r in prog.regions}
        return sorted(ai, key=lambda n: -ai[n])

    assert order(tprog, analyze_region) == order(jprog, jax_analyze)


@pytest.mark.parametrize("arch,pairs", [
    ("falcon-mamba-7b", [("ssm_scan", "hopper")]),
    # the fused MLP's and the chunked attention's intermediates exceed the
    # L2; the float32 rglru chunks (21 MB) fit it
    ("recurrentgemma-2b", [("rglru_scan", "hopper"), ("attn_core", "hopper"),
                           ("rglru_scan", "offload")]),
])
def test_cpu_plan_of_the_recurrent_programs_completes_then_hits(tmp_path, arch,
                                                                pairs):
    prog = make_lm_program(arch, seq=32, device="cpu")
    cfg = PlannerConfig(reps=2)
    cache = PlanCache(tmp_path / "plans.json")
    report = AutoOffloader(cfg).plan(prog, cache=cache)
    assert report.baseline.ok and report.measurements
    assert all(m.ok for m in report.measurements)
    assert sorted(report.eff_pairs) == sorted(pairs)
    again = AutoOffloader(cfg).plan(prog, cache=cache)
    assert again.from_cache and not again.measurements
    assert again.best_pattern == report.best_pattern
