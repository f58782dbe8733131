"""The port's ``launch/trend.py`` (its own copy of ``benchmarks/trend.py``):
snapshot discovery (flat, per-run and nested layouts), median-of-window
gating, its direction, the no-baseline exit, multi-column rows keyed and
never gated on their report-only metrics (the JAX test's verification
rows; the port writes replanning rows of that kind), and the sections the
port writes."""
import json

import pytest

from repro_torch.launch import trend


def _doc(best_ms, speedup=2.0, section="strategies"):
    return {"section": section,
            "rows": [{"app": "tdfir", "strategy": "staged",
                      "best_ms": best_ms, "speedup": speedup}]}


def _write(path, doc):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc))


def _history_dir(tmp_path, best_ms_values):
    base = tmp_path / "bench-baseline"
    for i, v in enumerate(best_ms_values):
        # the nested layout: <run-id>/<artifact-name>/BENCH_*.json
        _write(base / str(1000 + i) / f"bench-sha{i}" /
               "BENCH_strategies.json", _doc(v))
    return base


def test_load_history_flat_single_dir_is_one_snapshot(tmp_path):
    _write(tmp_path / "prev" / "BENCH_strategies.json", _doc(10.0))
    history = trend.load_history(str(tmp_path / "prev"))
    assert len(history) == 1
    assert history[0]["strategies"]["rows"][0]["best_ms"] == 10.0


def test_load_history_per_run_subdirs_nested_artifacts(tmp_path):
    base = _history_dir(tmp_path, [10.0, 11.0, 12.0])
    history = trend.load_history(str(base))
    assert [s["strategies"]["rows"][0]["best_ms"] for s in history] == \
        [10.0, 11.0, 12.0]


def test_load_history_window_keeps_newest_runs(tmp_path):
    base = _history_dir(tmp_path, [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0])
    history = trend.load_history(str(base), window=5)
    assert [s["strategies"]["rows"][0]["best_ms"] for s in history] == \
        [3.0, 4.0, 5.0, 6.0, 7.0]


def test_gate_compares_against_window_median(tmp_path, capsys):
    # median of [10, 10, 10, 30, 10] is 10 -> current 13 regresses 30%
    base = _history_dir(tmp_path, [10.0, 10.0, 10.0, 30.0, 10.0])
    current = tmp_path / "current"
    _write(current / "BENCH_strategies.json", _doc(13.0))
    rc = trend.main(["--baseline", str(base), "--current", str(current)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "median-of-5 10.00 -> 13.00" in out


def test_window_median_damps_single_noisy_baseline(tmp_path, capsys):
    """The failure mode the window exists for: ONE noisy-fast baseline
    sample (a compare-to-previous gate would compare with 5.0 and flag
    +140%); the median keeps the gate honest."""
    base = _history_dir(tmp_path, [12.0, 11.0, 12.5, 11.5, 5.0])
    current = tmp_path / "current"
    _write(current / "BENCH_strategies.json", _doc(12.0))
    rc = trend.main(["--baseline", str(base), "--current", str(current)])
    assert rc == 0
    assert "no gated regressions" in capsys.readouterr().out


def test_speedup_direction_higher_is_better(tmp_path):
    base = _history_dir(tmp_path, [10.0, 10.0, 10.0])
    current = tmp_path / "current"
    _write(current / "BENCH_strategies.json", _doc(10.0, speedup=1.0))
    rc = trend.main(["--baseline", str(base), "--current", str(current)])
    assert rc == 1                        # speedup 2.0 -> 1.0 is -50%


def test_no_baseline_exits_clean(tmp_path, capsys):
    current = tmp_path / "current"
    _write(current / "BENCH_strategies.json", _doc(10.0))
    rc = trend.main(["--baseline", str(tmp_path / "missing"),
                     "--current", str(current)])
    assert rc == 0
    assert "nothing to gate" in capsys.readouterr().out


def test_replanning_rows_keyed_and_not_pause_gated(tmp_path):
    """swap_tick_ms is report-only: a slower swap (a busier host) must
    never fail the gate; rows are identified by app + mode."""
    def rdoc(tick):
        return {"section": "replanning",
                "rows": [
                    {"app": "mistral-nemo-12b", "mode": "drift-swap",
                     "swap_tick_ms": tick, "median_tick_ms": tick / 2},
                    {"app": "replan_bench", "mode": "warm-reopen",
                     "n_measured_warm": 0, "speedup": 2.0},
                ]}
    base = tmp_path / "bench-baseline"
    for i in range(3):
        _write(base / str(i) / "BENCH_replanning.json", rdoc(2.0))
    current = tmp_path / "current"
    _write(current / "BENCH_replanning.json", rdoc(9.0))   # 4.5x slower swap
    rc = trend.main(["--baseline", str(base), "--current", str(current)])
    assert rc == 0


def test_current_dir_does_not_swallow_baseline_snapshots(tmp_path):
    """--current . next to bench-baseline/ must only read the flat files."""
    _history_dir(tmp_path, [10.0])
    _write(tmp_path / "BENCH_strategies.json", _doc(10.0))
    docs = trend.load_docs(str(tmp_path))
    assert list(docs) == ["strategies"]
    assert docs["strategies"]["rows"][0]["best_ms"] == 10.0


@pytest.mark.parametrize("section,row,key", [
    ("conditions", {"app": "tdfir", "best_ms": 1.0}, ("tdfir",)),
    ("strategies", {"app": "mriq", "strategy": "surrogate"},
     ("mriq", "surrogate")),
    ("extraction", {"app": "mixtral-8x7b", "tp": 3}, ("mixtral-8x7b",)),
    ("replanning", {"app": "mistral-nemo-12b", "mode": "drift-swap"},
     ("mistral-nemo-12b", "drift-swap")),
    ("kernels", {"name": "attn_core/hopper", "us_per_call": 9.0},
     ("attn_core/hopper",)),
])
def test_row_identity_of_every_section_the_port_writes(section, row, key):
    assert trend.row_key(section, row) == key


def test_extraction_counts_are_recorded_never_gated(tmp_path, capsys):
    def edoc(tp, fn):
        return {"section": "extraction",
                "rows": [{"app": "mistral-nemo-12b", "tp": tp, "fn": fn,
                          "regions": 3}]}
    base = tmp_path / "bench-baseline"
    _write(base / "0" / "BENCH_extraction.json", edoc(4, 1))
    current = tmp_path / "current"
    _write(current / "BENCH_extraction.json", edoc(2, 3))
    rc = trend.main(["--baseline", str(base), "--current", str(current)])
    out = capsys.readouterr().out
    assert rc == 0 and "tp 4.00->2.00" in out


def test_kernel_times_are_recorded_never_gated(tmp_path, capsys):
    def kdoc(us):
        return {"section": "kernels",
                "rows": [{"name": "attn_core/hopper", "us_per_call": us,
                          "launches": 5, "ran": True}]}
    base = tmp_path / "bench-baseline"
    for i in range(3):
        _write(base / str(i) / "BENCH_kernels.json", kdoc(10.0))
    current = tmp_path / "current"
    _write(current / "BENCH_kernels.json", kdoc(50.0))      # 5x slower
    rc = trend.main(["--baseline", str(base), "--current", str(current)])
    out = capsys.readouterr().out
    assert rc == 0 and "us_per_call 10.00->50.00" in out


def test_no_current_documents_is_an_error(tmp_path):
    (tmp_path / "empty").mkdir()
    assert trend.main(["--baseline", str(tmp_path), "--current",
                       str(tmp_path / "empty")]) == 1
