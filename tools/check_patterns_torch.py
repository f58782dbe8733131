#!/usr/bin/env python
"""Lint of the port's recognizer tables (``src/repro_torch``).

Every extractor family in ``src/repro_torch/core/extract.py::FAMILIES``
must map to a ``_match_*`` recognizer defined there in ``RECOGNIZERS``
(FAMILIES is a subset of RECOGNIZERS), and must declare at least one
positive and one negative test in
``tests/test_torch_extract.py::COVERAGE`` whose named test functions exist
in that file; COVERAGE may name no family outside FAMILIES.  A family
added without a recognizer or without both test polarities fails here
before it can ship with a recall of 0.

    python tools/check_patterns_torch.py

AST-based: nothing is imported.  Exit 0 when clean, 1 with one line per
violation otherwise.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
EXTRACT_PY = "src/repro_torch/core/extract.py"
EXTRACT_TESTS = "tests/test_torch_extract.py"


def _top_level_value(tree: ast.Module, name: str):
    """The AST node assigned to a module-level ``name = ...``, or None."""
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == name:
                    return node.value
    return None


def _literal(node):
    try:
        return ast.literal_eval(node) if node is not None else None
    except ValueError:
        return None


def check_recognizer_coverage(root: Path = ROOT) -> list[str]:
    """Families -> recognizers -> tests, checked statically under
    ``root``."""
    etree = ast.parse((root / EXTRACT_PY).read_text(), filename=EXTRACT_PY)
    ttree = ast.parse((root / EXTRACT_TESTS).read_text(),
                      filename=EXTRACT_TESTS)
    families = _literal(_top_level_value(etree, "FAMILIES"))
    rec_node = _top_level_value(etree, "RECOGNIZERS")
    if not isinstance(families, tuple) or not isinstance(rec_node, ast.Dict):
        return [f"{EXTRACT_PY}: FAMILIES (a literal tuple) or RECOGNIZERS "
                "(a dict) missing"]
    recognizers = {k.value: v.id for k, v in zip(rec_node.keys,
                                                  rec_node.values)
                   if isinstance(k, ast.Constant) and isinstance(v, ast.Name)}
    funcs = {n.name for n in ast.walk(etree) if isinstance(n, ast.FunctionDef)}
    tests = {n.name for n in ast.walk(ttree) if isinstance(n, ast.FunctionDef)}
    coverage = _literal(_top_level_value(ttree, "COVERAGE"))
    out = []
    if not isinstance(coverage, dict):
        out.append(f"{EXTRACT_TESTS}: COVERAGE dict missing (families must "
                   "declare their positive and negative extractor tests)")
        coverage = {}
    for fam in families:
        rec = recognizers.get(fam)
        if rec is None:
            out.append(f"{EXTRACT_PY}: family {fam!r} has no RECOGNIZERS "
                       "entry (add a _match_* recognizer)")
        elif not rec.startswith("_match_") or rec not in funcs:
            out.append(f"{EXTRACT_PY}: family {fam!r} maps to {rec!r}, "
                       "which is not a _match_* function defined there")
        entry = coverage.get(fam)
        for polarity in ("positive", "negative"):
            names = entry.get(polarity, ()) if isinstance(entry, dict) else ()
            if not names:
                out.append(f"{EXTRACT_TESTS}: family {fam!r} has no "
                           f"{polarity} case in COVERAGE")
            for name in names:
                if name not in tests:
                    out.append(f"{EXTRACT_TESTS}: COVERAGE names {name!r} "
                               f"for {fam!r} but no such test exists")
    for fam in coverage:
        if fam not in families:
            out.append(f"{EXTRACT_TESTS}: COVERAGE lists unknown family "
                       f"{fam!r}")
    return out


def main() -> int:
    violations = check_recognizer_coverage()
    for v in violations:
        print(v)
    if violations:
        print(f"\n{len(violations)} violation(s).")
        return 1
    print("check_patterns_torch: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
