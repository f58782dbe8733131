"""A checkout of the benchmark with two test cells added the way a later
change adds one: new files under ``bench/`` and new entries in
``BENCHMARK.json``, nothing edited.  The cells run the served models'
equations at a size the CPU serves in seconds."""
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = (("tiny", "tinychat", "tiny.chat"),
         ("tiny", "tinybatch", "tiny.batch"))


def add_cells(root: Path) -> None:
    doc = json.loads((root / "BENCHMARK.json").read_text())
    bench = root / "bench"
    for config, traffic, name in CELLS:
        shutil.copy(DATA / f"{config}.json", bench / "configs" / f"{config}.json")
        shutil.copy(DATA / f"{traffic}.json", bench / "traffic" / f"{traffic}.json")
        shutil.copy(DATA / f"{name}.limits.json", bench / "limits" / f"{name}.json")
        if all(c["name"] != config for c in doc["configs"]):
            doc["configs"].append({"name": config, "source": "test",
                                   "file": f"bench/configs/{config}.json",
                                   "reduced": [], "why": "test"})
        doc["workloads"].append({"name": name, "config": config,
                                 "traffic": traffic, "chips": 1,
                                 "why": "test"})
    for kind in ("end_to_end", "per_layer"):
        for m in doc[kind]:
            if "workloads" in m and "nemo12b.chat" in m["workloads"]:
                m["workloads"].append("tiny.chat")
    (root / "BENCHMARK.json").write_text(json.dumps(doc, indent=1))


@pytest.fixture
def checkout(tmp_path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``bench/`` with the test cells."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_cells(tmp_path)
    return tmp_path


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test process: the tiny cells' windows are a
    few seconds of host time, which several processes each running a
    thread per core would starve."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
