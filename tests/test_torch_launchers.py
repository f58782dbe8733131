"""The port's launchers and benchmark harness (``repro_torch.launch``):
each twin's ``main`` runs on the CPU at reduced sizes and its printed table
is checked, ``hopper`` rows are marked as not run there, each raises
without a card when no device is given, and the conditions table agrees
with the JAX package's on the paper apps' stage widths."""
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro.apps import mriq as jmriq
from repro.apps import tdfir as jtdfir
from repro.configs.paper_apps import MriQConfig as JMriQConfig
from repro.configs.paper_apps import TdFirConfig as JTdFirConfig
from repro.core.planner import AutoOffloader as JAutoOffloader
from repro.core.planner import PlannerConfig as JPlannerConfig
from repro_torch.launch import loop_extraction, trend

CPU = ["--device", "cpu"]
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the loop-faithful refs' small ops do not
    oversubscribe a machine shared with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def plan_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "plans.json"))
    return tmp_path


def _main(name):
    return importlib.import_module(f"repro_torch.launch.{name}").main


def test_quickstart_plans_then_serves_from_the_cache(plan_cache, capsys):
    first = _main("quickstart")(["--size", "24", "--reps", "1"] + CPU)
    second = _main("quickstart")(["--size", "24", "--reps", "1"] + CPU)
    out = capsys.readouterr().out
    assert not first.from_cache and first.measurements
    assert second.from_cache and second.measurements == []
    assert "offload plan: quickstart on cpu" in out
    assert "[served from plan cache]" in out and "plan served from cache" in out
    assert first.source_loop_count == 3 and first.loop_count == 2


def test_quickstart_registers_its_regions_only_when_it_runs():
    """Importing the port (every module) leaves the registry without the
    toy's regions; building its program registers them."""
    code = ("import importlib, pkgutil, repro_torch\n"
            "from repro_torch.core.regions import variants\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "assert not variants('blur') and not variants('hist')\n"
            "from repro_torch.launch.quickstart import make_program\n"
            "make_program(8, device='cpu')\n"
            "print(sorted(variants('blur')), sorted(variants('hist')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env={
                             **os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == "['offload', 'ref'] ['offload', 'ref']"


@pytest.mark.parametrize("name,banner,kernel", [
    ("offload_fir", "tdFIR automatic offload", "fir_filter_bank"),
    ("offload_mriq", "MRI-Q automatic offload", "mriq_compute_q")])
def test_paper_app_launchers(plan_cache, capsys, name, banner, kernel):
    res = _main(name)(["--reduced", "--reps", "1"] + CPU)
    out = capsys.readouterr().out
    assert banner in out and "loops: source=" in out
    # on the CPU the hopper kernel is not run, and says so
    assert res["max_abs_err"] is None
    assert f"deploy kernel validation ({kernel}, hopper)" in out
    assert "hopper not run on cpu" in out
    proj = res["projection"]
    assert proj["seconds"] > 0 and proj["bound"] in ("compute", "memory",
                                                     "transcendental")
    assert "projected H100 kernel time" in out and "700 W" in out


def test_offload_transformer(plan_cache, capsys):
    rep = _main("offload_transformer")(
        ["--arch", "recurrentgemma-2b", "--reps", "1", "--no-cache"] + CPU)
    out = capsys.readouterr().out
    assert rep.program == "lm:recurrentgemma-2b" and rep.measurements
    assert {c.region for c in rep.candidates} == {"attn_core", "mlp_core",
                                                  "rglru_scan"}
    assert "attn_core->flash_attention" in out
    assert "rglru_scan->rglru_scan" in out


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-small"])
def test_serve_lm(capsys, arch):
    res = _main("serve_lm")(["--arch", arch, "--reduced", "--requests", "3",
                             "--prompt-len", "8", "--new-tokens", "4",
                             "--temperature", "0.7", "--top-k", "5"] + CPU)
    out = capsys.readouterr().out
    st = res["stats"]
    assert st["requests_finished"] == 3 and st["generated_tokens"] == 12
    assert len(res["done"][0].generated) == 4
    assert f"arch={arch}-reduced slots=4 requests=3 on cpu" in out
    assert "ttft:" in out and "first calls" in out and "tok/s aggregate" in out
    assert f"prefill first calls: {st['prefill_traces']}" in out


def test_kernel_bench_marks_hopper_not_run_on_the_cpu(capsys, tmp_path):
    rows = _main("kernel_bench")(["--reduced", "--reps", "1", "--json",
                                  str(tmp_path / "k.json")] + CPU)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    names = [r["name"] for r in rows]
    assert names[:3] == ["attn_core/ref", "attn_core/hopper",
                         "attn_core/offload"]
    assert {"rglru_scan/hopper", "ssm_scan/seq", "mlp_core/offload"} <= set(
        names)
    for r in rows:
        if r["name"].endswith("/hopper"):
            assert not r["ran"] and r["us_per_call"] is None
            assert (f"{r['name']},not run,hopper is a CUDA kernel: timed on "
                    "a card only") in out
        else:
            assert r["ran"] and r["us_per_call"] > 0
            assert r["h100_proj_us"] > 0 and r["launches"] == 0
    assert sum(1 for line in out if ",not run," in line) == 3
    doc = json.loads((tmp_path / "k.json").read_text())
    assert doc["section"] == "kernels" and doc["device"] == "cpu"


def _jax_widths(make, cfg) -> tuple:
    rep = JAutoOffloader(JPlannerConfig(reps=1, max_measurements=1)).plan(
        make(cfg, cfg), jax.random.PRNGKey(0))
    return (rep.source_loop_count, rep.jaxpr_loop_count, len(rep.candidates),
            len(rep.ai_selected), len(rep.eff_selected))


def test_conditions_table_agrees_with_jax_stage_widths(capsys, tmp_path):
    path = tmp_path / "BENCH_conditions.json"
    rows = loop_extraction.main(["--conditions", "--reduced", "--json",
                                 str(path)] + CPU)["conditions"]
    out = capsys.readouterr().out
    assert ("app,source_loops,traced_loops,regions,after_ai(a<=5),"
            "after_eff(c<=3),measured(d<=4)") in out
    by = {r["app"]: r for r in rows}
    assert by["tdfir"]["source_loops"] == 36 and by["mriq"]["source_loops"] == 16
    for r in rows:
        assert r["after_ai"] <= 5 and r["after_eff"] <= 3 and r["measured"] <= 4
    # the same small sizes through the JAX planner's Steps 1-3
    t, q = loop_extraction.TDFIR_SMALL, loop_extraction.MRIQ_SMALL
    want = {"tdfir": _jax_widths(jtdfir.make_program, JTdFirConfig(
                t.n_banks, t.n_taps, t.n_samples)),
            "mriq": _jax_widths(jmriq.make_program, JMriQConfig(q.num_x,
                                                                q.num_k))}
    for app, widths in want.items():
        r = by[app]
        assert (r["source_loops"], r["traced_loops"], r["regions"],
                r["after_ai"], r["after_eff"]) == widths, app
    doc = json.loads(path.read_text())
    assert doc["section"] == "conditions" and doc["rows"] == rows


def test_run_writes_documents_that_trend_reads(tmp_path, capsys):
    bench = tmp_path / "bench"
    for section in ("kernels", "conditions"):
        _main("run")(["--section", section, "--json", "--out", str(bench),
                      "--reps", "1", "--reduced"] + CPU)
    assert sorted(p.name for p in bench.iterdir()) == [
        "BENCH_conditions.json", "BENCH_kernels.json"]
    capsys.readouterr()
    assert trend.main(["--baseline", str(tmp_path / "none"), "--current",
                       str(bench)]) == 0
    assert "nothing to gate" in capsys.readouterr().out
    assert trend.main(["--baseline", str(bench), "--current",
                       str(bench)]) == 0
    assert "no gated regressions" in capsys.readouterr().out


@pytest.mark.parametrize("name,argv", [
    ("quickstart", []), ("offload_fir", []), ("offload_mriq", []),
    ("offload_transformer", []), ("serve_lm", ["--reduced"]),
    ("kernel_bench", ["--reduced"]),
    ("run", ["--section", "conditions"]),
    ("loop_extraction", ["--conditions"])])
def test_entry_points_raise_without_a_card(name, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _main(name)(argv)
