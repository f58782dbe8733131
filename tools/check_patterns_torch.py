#!/usr/bin/env python
"""Lint of the port (``src/repro_torch``): the rules of
``tools/check_patterns.py``, applied to the port's trees.

1. ``time.time()`` in timed paths (``core``, ``serving``, ``launch``):
   wall-clock time is not monotonic (clock steps and slews corrupt
   intervals); timed code uses ``time.perf_counter()`` or CUDA events.  A
   deliberate exception takes a ``# wallclock: <why>`` comment on the same
   line.

2. ``sys.path`` edits (``insert`` / ``append``) in ``launch/`` and in
   ``chip_smoke.py``: entry points run with ``PYTHONPATH=src`` (or ``python
   -m``), not by editing ``sys.path`` at import.  ``chip_smoke.py`` is
   exempt by a ``# sys-path: <why>`` comment on the line of its one edit:
   the card's contract runs it as ``python3 chip_smoke.py``, with no
   PYTHONPATH, from the root of a checkout.

3. Undeclared tuning knobs: a ``@register_variant`` function whose
   keyword-only signature exposes tile knobs (``block_*`` / ``*_unroll`` /
   ``*_chunk``) must declare a ``TuningSpace`` through the decorator's
   ``tuning=`` keyword, or the autotuner never searches them.  A knob that
   is deliberately not tunable takes a ``# no-tuning: <why>`` comment on
   the decorator line.

4. Silent exception swallowing in the fault-tolerant trees (``core`` and
   ``serving``): a bare ``except:`` / ``except Exception:`` / ``except
   BaseException:`` whose body is only ``pass`` hides the failures the
   fault layer must classify, retry or quarantine.  A broad handler that
   re-raises, returns, records or logs is accepted (``core/search.py``'s
   compile and run steps return a failed result that is classified
   downstream; ``core/regions.py``'s validity predicate returns False, an
   invalid point): the rule is about handlers that do nothing.

5. Recognizer coverage: every extractor family in
   ``src/repro_torch/core/extract.py::FAMILIES`` maps to a ``_match_*``
   recognizer defined there in ``RECOGNIZERS`` (FAMILIES is a subset of
   RECOGNIZERS), and declares at least one positive and one negative test
   in ``tests/test_torch_extract.py::COVERAGE`` whose named test functions
   exist in that file; COVERAGE names no family outside FAMILIES.

    python tools/check_patterns_torch.py

AST-based (comments and strings may name the patterns freely): nothing is
imported.  Exit 0 when clean, 1 with one line per violation otherwise.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = "src/repro_torch"
TIME_TIME_TREES = (f"{PORT}/core", f"{PORT}/serving", f"{PORT}/launch")
WALLCLOCK_WAIVER = "# wallclock:"
SYS_PATH_TREES = (f"{PORT}/launch",)
SYS_PATH_FILES = ("chip_smoke.py",)
SYS_PATH_WAIVER = "# sys-path:"
SYS_PATH_EDITS = ("sys.path.insert", "sys.path.append")
KNOB_PREFIXES = ("block_",)
KNOB_SUFFIXES = ("_unroll", "_chunk")
TUNING_WAIVER = "# no-tuning:"
SILENT_EXCEPT_TREES = (f"{PORT}/core", f"{PORT}/serving")
EXTRACT_PY = f"{PORT}/core/extract.py"
EXTRACT_TESTS = "tests/test_torch_extract.py"


def _attr_chain(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _sources(root: Path, trees=(), files=()) -> list[Path]:
    paths = [p for t in trees for p in sorted((root / t).rglob("*.py"))]
    return paths + [root / f for f in files if (root / f).exists()]


def _parse(path: Path):
    """(tree, lines) of a source, or (None, lines) when it does not
    parse (reported once, by the caller of :func:`_calls`)."""
    src = path.read_text()
    try:
        return ast.parse(src, filename=str(path)), src.splitlines()
    except SyntaxError:
        return None, src.splitlines()


def _calls(root: Path, paths, chains: tuple, waiver: str, fix: str):
    """Calls of any of ``chains`` in ``paths``, less those whose line
    carries ``waiver``."""
    out = []
    for path in paths:
        tree, lines = _parse(path)
        rel = path.relative_to(root)
        if tree is None:
            out.append(f"{rel}: does not parse")
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if chain not in chains:
                continue
            line = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
            if waiver in line:
                continue
            out.append(f"{rel}:{node.lineno}: {chain} forbidden here ({fix})")
    return out


def check_time_time(root: Path = ROOT) -> list[str]:
    """Rule 1: no ``time.time()`` in the timed trees."""
    return _calls(root, _sources(root, TIME_TIME_TREES), ("time.time",),
                  WALLCLOCK_WAIVER,
                  "use time.perf_counter() or CUDA events for intervals, or "
                  f"waive with '{WALLCLOCK_WAIVER} <why>'")


def check_sys_path(root: Path = ROOT) -> list[str]:
    """Rule 2: no ``sys.path`` edits in the launchers (chip_smoke.py's one
    edit carries its waiver)."""
    return _calls(root, _sources(root, SYS_PATH_TREES, SYS_PATH_FILES),
                  SYS_PATH_EDITS, SYS_PATH_WAIVER,
                  "run via PYTHONPATH=src or python -m instead")


def _register_variant_call(dec: ast.expr):
    if isinstance(dec, ast.Call) and (
            (isinstance(dec.func, ast.Name)
             and dec.func.id == "register_variant")
            or (isinstance(dec.func, ast.Attribute)
                and dec.func.attr == "register_variant")):
        return dec
    return None


def check_tuning_spaces(root: Path = ROOT) -> list[str]:
    """Rule 3: a registered variant with tile knobs among its keyword-only
    arguments declares a TuningSpace (``tuning=``) or carries the
    ``# no-tuning: <why>`` waiver on its decorator line."""
    out = []
    for path in _sources(root, (PORT,)):
        tree, lines = _parse(path)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for dec in node.decorator_list:
                call = _register_variant_call(dec)
                if call is None:
                    continue
                knobs = [a.arg for a in node.args.kwonlyargs
                         if a.arg.startswith(KNOB_PREFIXES)
                         or a.arg.endswith(KNOB_SUFFIXES)]
                if not knobs or any(kw.arg == "tuning"
                                    for kw in call.keywords):
                    continue
                if TUNING_WAIVER in lines[call.lineno - 1]:
                    continue
                out.append(
                    f"{path.relative_to(root)}:{node.lineno}: variant "
                    f"{node.name!r} exposes tuning knob(s) "
                    f"{', '.join(knobs)} but its register_variant declares "
                    f"no TuningSpace (add tuning=TuningSpace(...) or a "
                    f"'{TUNING_WAIVER} <why>' comment)")
    return out


def _is_broad_handler(handler: ast.ExceptHandler) -> bool:
    """Bare ``except:`` or ``except Exception/BaseException:`` (a typed
    handler names what it absorbs)."""
    t = handler.type
    return t is None or (isinstance(t, ast.Name)
                         and t.id in ("Exception", "BaseException"))


def check_silent_excepts(root: Path = ROOT) -> list[str]:
    """Rule 4: no broad handler whose body is only ``pass`` in the
    fault-tolerant trees."""
    out = []
    for path in _sources(root, SILENT_EXCEPT_TREES):
        tree, _ = _parse(path)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if (isinstance(node, ast.ExceptHandler)
                    and _is_broad_handler(node)
                    and all(isinstance(s, ast.Pass) for s in node.body)):
                out.append(f"{path.relative_to(root)}:{node.lineno}: broad "
                           "silent except (name the exception types or "
                           "record the failure: silent swallowing defeats "
                           "fault classification)")
    return out


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
    """Rule 5: families -> recognizers -> tests, checked statically under
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


CHECKS = (check_time_time, check_sys_path, check_tuning_spaces,
          check_silent_excepts, check_recognizer_coverage)


def main(root: Path = ROOT) -> int:
    violations = [v for check in CHECKS for v in check(root)]
    for v in violations:
        print(v)
    if violations:
        print(f"\n{len(violations)} violation(s).")
        return 1
    print("check_patterns_torch: clean (rules 1-5)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
