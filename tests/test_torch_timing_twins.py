"""The port's verification, autotune and faults twins
(``repro_torch.launch.{verification,autotune,faults}``) and rule P
(``launch/paired.py``) on the CPU, in this process: the deterministic
claims of each twin at reduced sizes (sequences, counts, search spaces,
compile-cache hits, quarantine, rollback), the paired re-time on a
scripted clock with both decisions either side of 1.05, the trend keys
against the JAX package's ``benchmarks/trend.py``, a ``run`` document that
``trend`` reads, and ``run`` routing each section to its twin.  No timing
claim is asserted here."""
import importlib
import json

import pytest
import torch

from benchmarks import trend as jtrend
from repro.apps import tdfir as jtdfir
from repro.configs.paper_apps import TdFirConfig as JTdFirConfig
from repro.core import regions as JR
from repro_torch.apps import tdfir as ttdfir
from repro_torch.configs.paper_apps import TdFirConfig
from repro_torch.core import regions as TR
from repro_torch.launch import autotune, faults, paired, run, trend
from repro_torch.launch import verification

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the loop-faithful refs' small ops do not
    oversubscribe a machine shared with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def verification_doc(tmp_path_factory):
    out = tmp_path_factory.mktemp("bench")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run.main(["--section", "verification", "--json", "--out", str(out),
                  "--reduced"] + CPU)
    finally:
        torch.set_num_threads(n)
    return out, json.loads((out / "BENCH_verification.json").read_text())


@pytest.fixture(scope="module")
def autotune_doc(tmp_path_factory):
    path = tmp_path_factory.mktemp("autotune") / "BENCH_autotune.json"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        autotune.main(["--reduced", "--json", str(path)] + CPU)
    finally:
        torch.set_num_threads(n)
    return json.loads(path.read_text())


# --------------------------------------------------------------------------
# verification
# --------------------------------------------------------------------------
def test_verification_plans_measure_the_same_sequence(verification_doc):
    _, doc = verification_doc
    serial, piped, warm = doc["rows"]
    assert (serial["workers"], piped["workers"], warm["workers"]) == (1, 4, 4)
    assert [r["cached_replan"] for r in doc["rows"]] == [False, False, True]
    assert serial["patterns"] == piped["patterns"] == warm["patterns"]
    assert serial["n_measured"] == piped["n_measured"] \
        == warm["n_measured"] >= 6
    assert len(set(serial["patterns"])) == serial["n_measured"]


def test_verification_warm_replan_hits_the_compile_cache(verification_doc):
    _, doc = verification_doc
    serial, piped, warm = doc["rows"]
    assert serial["compile_cache_hits"] == piped["compile_cache_hits"] == 0
    assert warm["compile_cache_hits"] >= warm["n_measured"]


def test_verification_document_has_the_jax_keys(verification_doc):
    _, doc = verification_doc
    assert doc["section"] == "verification" and doc["backend"] == "cpu"
    for key in ("cpus", "budget", "pipeline_speedup", "cached_replan_speedup",
                "identical_winner", "max_run_seconds_rel_dev"):
        assert key in doc
    for r in doc["rows"]:
        for key in ("app", "workers", "n_measured", "patterns", "run_seconds",
                    "compile_seconds", "compile_wall_s", "verify_wall_s",
                    "best_pattern", "best_ms", "baseline_ms",
                    "speedup_vs_baseline", "decided_by"):
            assert key in r
        assert r["decided_by"] in ("plan", "retry", "paired")
        assert ("paired_ratio" in r) == (r["decided_by"] == "paired")


def test_run_writes_a_verification_document_that_trend_reads(
        verification_doc, tmp_path, capsys):
    out, _ = verification_doc
    capsys.readouterr()
    assert trend.main(["--baseline", str(tmp_path / "none"), "--current",
                       str(out)]) == 0
    assert "nothing to gate" in capsys.readouterr().out
    assert trend.main(["--baseline", str(out), "--current", str(out)]) == 0
    got = capsys.readouterr().out
    assert "veribench/4/True" in got and "no gated regressions" in got


# --------------------------------------------------------------------------
# autotune
# --------------------------------------------------------------------------
def test_autotune_tuned_space_is_larger_than_the_fixed(autotune_doc):
    by = {(r["app"], r["mode"]): r for r in autotune_doc["rows"]}
    for app in ("tdfir", "decode_attn"):
        assert by[(app, "tuned")]["search_space"] > \
            by[(app, "fixed")]["search_space"]
    assert by[("tdfir", "tuned-surrogate")]["search_space"] == \
        by[("tdfir", "tuned-exhaustive")]["search_space"]
    exh = by[("tdfir", "tuned-exhaustive")]
    assert exh["n_measured"] == exh["budget"] == 8
    assert by[("tdfir", "tuned-surrogate")]["n_measured"] < 8


def test_autotune_workers_measure_the_same_sequence(autotune_doc):
    det = autotune_doc["workers_determinism"]
    assert det["patterns"] and det["decided_by"] in ("plan", "retry",
                                                     "paired")


def test_autotune_hot_replan_measures_nothing(autotune_doc):
    demo = autotune_doc["warm_cache"]
    assert demo["cold_measured"] >= 1
    assert demo["hot_from_cache"] and demo["hot_measured"] == 0
    assert demo["reopened_measured"] == 0
    assert demo["reopened_reused"] == demo["cold_measured"]


@pytest.mark.parametrize("cfg", [None, (4, 16, 256)])
def test_fir_bank_tuning_space_matches_jax(cfg):
    if cfg is None:
        jargs = jtdfir.make_program().regions[1].analysis_args
        targs = ttdfir.make_program(device="cpu").regions[1].analysis_args
    else:
        jc, tc = JTdFirConfig(*cfg), TdFirConfig(*cfg)
        jargs = jtdfir.make_program(jc, jc).regions[1].analysis_args
        targs = ttdfir.make_program(tc, tc, device="cpu").regions[1] \
            .analysis_args
    jspace = JR.tuning_space("fir_bank", "pallas")
    tspace = TR.tuning_space("fir_bank", "hopper")
    assert tspace.size(targs) == jspace.size(jargs) == (16 if cfg is None
                                                        else 8)
    assert tspace.points(targs) == jspace.points(jargs)


# --------------------------------------------------------------------------
# faults
# --------------------------------------------------------------------------
def test_faults_storm_quarantines_the_nan_gene_and_rollback_drops_nothing(
        capsys):
    storm, rollback = faults.main(["--reduced"] + CPU)
    assert storm["n_faults_injected"] > 0 and storm["n_retries"] > 0
    # which healthy pattern wins is timed (asserted on a card only): the
    # NaN gene never wins
    assert storm["best_pattern"] in ("all-ref", f"{faults.A}=offload")
    assert storm["quarantined"] == [f"{faults.B}=offload"]
    assert storm["n_quarantined"] == 1
    assert rollback["app"] == "qwen2-72b" and rollback["rollbacks"] == 1
    assert rollback["requests"] == faults.TICKS
    assert rollback["rollback_tick"] > faults.OFFER_TICK
    assert "0 dropped" in capsys.readouterr().out


def _fault_rows(**change):
    """A storm and a rollback row that pass every check, with ``change``
    applied (a key of either row)."""
    a, b = f"{faults.A}=offload", f"{faults.B}=offload"
    storm = dict(n_faults_injected=4, n_retries=3, quarantined=[b],
                 best_pattern=a, clean_best_pattern=f"{a}+{b}")
    rb = dict(rollbacks=1, requests=12, submitted=12, rollback_tick_ms=30.0,
              median_tick_ms=15.0)
    for key, value in change.items():
        (storm if key in storm else rb)[key] = value
    return [storm, rb]


@pytest.mark.parametrize("change,timing", [
    ({}, None),
    ({"best_pattern": "all-ref"}, "storm winner"),
    ({"clean_best_pattern": f"{faults.A}=offload"}, "clean winner"),
    ({"rollback_tick_ms": 151.0}, "rollback tick"),
    ({"n_retries": 0}, False),
    ({"quarantined": []}, False),
    ({"best_pattern": f"{faults.B}=offload"}, False),
    ({"rollbacks": 2}, False),
    ({"requests": 11}, False)])
def test_faults_timed_claims_are_asserted_on_a_card_only(change, timing):
    rows = _fault_rows(**change)
    if timing is None:
        faults.check(rows)
        faults.check(rows, timed=False)
    elif timing is False:               # not a clock's claim: fails anywhere
        for timed in (True, False):
            with pytest.raises(AssertionError):
                faults.check(rows, timed=timed)
    else:
        with pytest.raises(AssertionError, match=timing):
            faults.check(rows)
        faults.check(rows, timed=False)


# --------------------------------------------------------------------------
# rule P
# --------------------------------------------------------------------------
def _scripted(ratios):
    """A, B callables that log their order, and a clock that gives A 1.0 s
    and B r s in round r (the warm-up calls are not timed)."""
    log = []
    seconds = iter(t for r in ratios for t in (1.0, r, r, 1.0))
    a, b = (lambda: log.append("A")), (lambda: log.append("B"))

    def timer(fn):
        fn()
        return next(seconds)

    return a, b, timer, log


def test_paired_ratio_runs_a_b_b_a_and_takes_the_median():
    ratios = [1.2, 0.9, 1.049, 1.3, 1.0]
    a, b, timer, log = _scripted(ratios)
    assert paired.paired_ratio(a, b, timer=timer) == pytest.approx(1.049)
    assert log == ["A", "B"] + ["A", "B", "B", "A"] * paired.ROUNDS
    a, b, timer, _ = _scripted([2.0, 3.0, 1.5])
    assert paired.paired_ratio(a, b, timer=timer, rounds=3) == 2.0


@pytest.mark.parametrize("ratio,tie,no_slower", [
    (1.049, True, True), (1.051, False, False),
    (1 / 1.049, True, True), (1 / 1.051, False, True)])
def test_rule_p_decisions_either_side_of_the_bound(ratio, tie, no_slower):
    assert paired.ties(ratio) is tie
    assert paired.no_slower(ratio) is no_slower


@pytest.mark.parametrize("ratio,passes", [(1.049, True), (1.051, False)])
def test_twins_decide_a_differing_winner_by_the_paired_ratio(ratio, passes):
    row = dict(patterns=["p"], n_measured=6, best_pattern={"r": "ref"},
               workers=1, cached_replan=False, decided_by="retry")
    other = dict(row, workers=4, best_pattern={"r": "offload"},
                 decided_by="paired", paired_ratio=ratio)
    rows = [row, other, dict(row, workers=4, cached_replan=True)]
    fixed = dict(app="tdfir", mode="fixed", search_space=1, best_ms=1.0,
                 best_pattern="all-ref",
                 decided_by="paired", paired_ratio=ratio)
    tuned = dict(fixed, mode="tuned", search_space=2, best_ms=2.0)
    tune_rows = [fixed, tuned,
                 dict(fixed, app="decode_attn"),
                 dict(tuned, app="decode_attn"),
                 dict(app="tdfir", mode="tuned-surrogate", n_measured=7),
                 dict(app="tdfir", mode="tuned-exhaustive", n_measured=8)]
    det = dict(decided_by="paired", paired_ratio=ratio, winner="a",
               winner_w2="b")
    demo = dict(hot_from_cache=True, hot_measured=0)
    checks = (lambda: verification.check(rows),
              lambda: autotune.check(tune_rows, det, demo, 8))
    for check in checks:
        if passes:
            check()
        else:
            with pytest.raises(AssertionError, match="paired ratio"):
                check()
    # the CPU's host clock decides nothing
    verification.check(rows, timed=False)
    autotune.check(tune_rows, det, demo, 8, timed=False)


def test_retime_builds_both_patterns_on_one_input():
    prog = verification.make_program("cpu", reduced=True)
    offload = {verification._region_names()[0]: "offload"}
    ratio = paired.retime(prog, {}, offload, rounds=1)
    assert 0.0 < ratio < float("inf")


# --------------------------------------------------------------------------
# trend and run
# --------------------------------------------------------------------------
def test_trend_keys_and_metrics_equal_the_jax_harness():
    for section, keys in jtrend.SECTION_KEYS.items():
        assert trend.SECTION_KEYS[section] == keys, section
    for metric, direction in jtrend.METRICS.items():
        assert trend.METRICS[metric] == direction, metric


@pytest.mark.parametrize("section,argv,want", [
    ("verification", [], ["--budget", "8", "--reps", "3", "--reduced"]),
    ("autotune", [], ["--budget", "8", "--reps", "2", "--reduced"]),
    ("faults", ["--arch", "mistral-nemo-12b"],
     ["--arch", "mistral-nemo-12b", "--reduced"]),
])
def test_run_routes_each_section_to_its_twin(monkeypatch, section, argv,
                                             want):
    seen = []
    mod = importlib.import_module(f"repro_torch.launch.{section}")
    monkeypatch.setattr(mod, "main", lambda a: seen.append(a) or "ran")
    got = run.main(["--section", section, "--reduced"] + argv + CPU)
    assert got == {section: "ran"}
    assert seen == [want + CPU]
