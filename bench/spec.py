"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; a
configuration's file is its entry's ``file``; a mix ``<traffic>`` is
``bench/traffic/<traffic>.json``; a metric ``<name>`` is read by
``bench/metrics/<name>.py``, whose ``read(run)`` returns its value or
None when it finds nothing to read; a cell's correctness limits are
``bench/limits/<workload>.json``.  Adding a cell, a configuration, a mix
or a metric is adding files and entries: nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path


class Spec:
    def __init__(self, root):
        self.root = Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench = self.root / "bench"

    def _entry(self, key: str, name: str) -> dict:
        for e in self.doc[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"{key} has no entry named {name!r}")

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        """The configuration file's contents."""
        return json.loads((self.root / self._entry("configs", name)["file"])
                          .read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> dict:
        return json.loads((self.bench / "limits" / f"{workload}.json")
                          .read_text())

    def metrics(self, workload: str, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` entries this cell reports: a
        metric's ``workloads`` where it has one; otherwise every cell (an
        end-to-end metric) or every cell that reports the end-to-end metric
        it ``moves`` (a per-layer one)."""
        e2e = [m["name"] for m in self.metrics(workload, "end_to_end")] \
            if kind == "per_layer" else None
        out = []
        for m in self.doc[kind]:
            if "workloads" in m:
                if workload in m["workloads"]:
                    out.append(m)
            elif kind == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out

    def reader(self, metric: str):
        """The module of ``bench/metrics/<metric>.py``, loaded by path (a
        metric's name may hold dots)."""
        path = self.bench / "metrics" / f"{metric}.py"
        mod_name = "bench_metric_" + metric.replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        if spec is None:
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
