"""The harness finds a cell's files by name, so a later change adds a
cell, a mix or a metric with new files and entries alone; and nothing the
benchmark runs imports JAX, the JAX package or its benchmarks, nor the
reference anything of the program."""
import ast
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench import generator
from bench.harness import FORBIDDEN
from bench.spec import Spec
from bench.tests.conftest import REPO

BENCH = REPO / "bench"


def test_discovery_of_an_added_cell_mix_and_metric(checkout):
    bench = checkout / "bench"
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps({
        "kind": "open_loop", "rate_rps": 1.5,
        "prompt": {"dist": "lognormal", "median": 100, "sigma": 0.5,
                   "min": 8, "max": 400},
        "output": {"dist": "lognormal", "median": 10, "sigma": 0.5,
                   "min": 2, "max": 50},
        "slots": 8, "ctx": 512, "tail_s": 5,
        "check": {"served_tokens": 100, "requests": 4},
        "trace": {"seconds": 2}}))
    (bench / "metrics" / "dummy.share.py").write_text(
        '"""Requests in the window."""\n\n\ndef read(run):\n'
        '    return float(len(run.window.served))\n')
    (bench / "limits" / "tiny.dummy_mix.json").write_text(
        json.dumps({"max_logit_gap": 0.25}))
    doc = json.loads((checkout / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "tiny.dummy_mix", "config": "tiny",
                             "traffic": "dummy_mix", "chips": 1,
                             "why": "a dummy"})
    doc["per_layer"].append({"name": "dummy.share", "unit": "%",
                             "better": "higher", "source": "host_clock",
                             "layer": "engine", "moves": "output_tok_s",
                             "workloads": ["tiny.dummy_mix"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(doc))

    spec = Spec(checkout)
    cell = spec.workload("tiny.dummy_mix")
    config = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    assert config["hidden_size"] == 256 and mix["rate_rps"] == 1.5
    assert spec.limits("tiny.dummy_mix")["max_logit_gap"] == 0.25
    plan = generator.schedule(mix, 2**31 + 5, 10.0, config["vocab_size"])
    assert sum(p.in_window for p in plan) == 15
    names = {m["name"] for m in spec.metrics("tiny.dummy_mix", "per_layer")}
    # its own metric, and those without a cell list that move a metric the
    # cell reports; not the chat cells' own
    assert "dummy.share" in names and "slot_occupancy" in names
    assert "queue_wait_p50_ms" not in names
    e2e = {m["name"] for m in spec.metrics("tiny.dummy_mix", "end_to_end")}
    assert e2e == {"output_tok_s", "setup_s"}
    run = SimpleNamespace(window=SimpleNamespace(served=[1, 2, 3]))
    assert spec.reader("dummy.share").read(run) == 3.0
    # the committed cells are untouched by the addition
    assert {m["name"] for m in spec.metrics("nemo12b.chat", "per_layer")} == {
        m["name"] for m in Spec(REPO).metrics("nemo12b.chat", "per_layer")}


def test_every_metric_has_a_reader_and_every_cell_its_files():
    spec = Spec(REPO)
    for kind in ("end_to_end", "per_layer"):
        for m in spec.doc[kind]:
            assert callable(spec.reader(m["name"]).read), m["name"]
    for w in spec.doc["workloads"]:
        spec.config(w["config"])
        spec.traffic(w["traffic"])
        limits = spec.limits(w["name"])
        assert set(limits) == {"max_logit_gap"}
        assert limits["max_logit_gap"] > 0
        reported = {m["name"] for m in spec.metrics(w["name"], "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.metrics(w["name"], "per_layer")


def _imports(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_nor_the_jax_package(path):
    # whole top-level names: repro_torch begins with repro and is allowed
    assert not _imports(path) & set(FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        names = _imports(path)
        assert "repro_torch" not in names, path
        # nor what the benchmark gets from the program
        assert not ({"bench"} & names) or _bench_imports(path) <= {
            "bench.counts"}, path


def _bench_imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith("bench"):
            out.add(node.module)
        elif isinstance(node, ast.Import):
            out |= {a.name for a in node.names if a.name.startswith("bench")}
    return out
