"""``tools/check_patterns_torch.py``: the port's recognizer tables are
clean, and each kind of hole in them is reported (on copies of the two
files with the hole put in)."""
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TOOL = ROOT / "tools" / "check_patterns_torch.py"


def _tool():
    spec = importlib.util.spec_from_file_location("check_patterns_torch", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_tables_are_clean():
    proc = subprocess.run([sys.executable, str(TOOL)], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean" in proc.stdout
    assert _tool().check_recognizer_coverage() == []


def _copy(tmp_path, mod):
    for rel in (mod.EXTRACT_PY, mod.EXTRACT_TESTS):
        dst = tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text((ROOT / rel).read_text())
    return tmp_path


@pytest.mark.parametrize("hole,which,old,new,want", [
    ("no recognizer", "py", '    "conv_stem": _match_conv_stem,\n', "",
     "family 'conv_stem' has no RECOGNIZERS entry"),
    ("not a matcher", "py", '"mlp_gelu": _match_gelu_mlp,',
     '"mlp_gelu": _peel,', "which is not a _match_* function"),
    ("no negative", "tests",
     '"negative": ["test_dilated_conv_rejected_with_diagnostic"]',
     '"negative": []', "family 'conv_stem' has no negative case"),
    ("missing test", "tests", '"positive": ["test_gelu_mlp_rediscovered"]',
     '"positive": ["test_gelu_mlp_found_nowhere"]',
     "names 'test_gelu_mlp_found_nowhere' for 'mlp_gelu'"),
    ("unknown family", "tests", "COVERAGE = {\n",
     'COVERAGE = {\n    "conv2d_stem": {"positive": [], "negative": []},\n',
     "COVERAGE lists unknown family 'conv2d_stem'"),
])
def test_each_hole_is_reported(tmp_path, hole, which, old, new, want):
    mod = _tool()
    root = _copy(tmp_path, mod)
    path = root / (mod.EXTRACT_PY if which == "py" else mod.EXTRACT_TESTS)
    text = path.read_text()
    assert text.count(old) == 1, hole
    path.write_text(text.replace(old, new))
    found = mod.check_recognizer_coverage(root)
    assert any(want in v for v in found), (hole, found)


# rules 1-4 on a tree of one file each: (check, path, source, the
# violation it must report or None for a clean tree)
_VARIANT = ('from repro_torch.core.regions import register_variant\n'
            '@register_variant("attn_core", "x"{extra})\n'
            'def f(q, *, block_k=64):\n'
            '    return q\n')
RULES = [
    ("time.time", "check_time_time", "src/repro_torch/core/t.py",
     "import time\nt0 = time.time()\n", "time.time forbidden here"),
    ("time.time waived", "check_time_time", "src/repro_torch/serving/t.py",
     "import time\nt0 = time.time()  # wallclock: a log stamp\n", None),
    ("perf_counter", "check_time_time", "src/repro_torch/launch/t.py",
     "import time\nt0 = time.perf_counter()\n", None),
    ("sys.path in launch", "check_sys_path", "src/repro_torch/launch/s.py",
     "import sys\nsys.path.insert(0, 'src')\n", "sys.path.insert forbidden"),
    ("sys.path append", "check_sys_path", "src/repro_torch/launch/s.py",
     "import sys\nsys.path.append('src')\n", "sys.path.append forbidden"),
    ("chip_smoke unwaived", "check_sys_path", "chip_smoke.py",
     "import sys\nsys.path.insert(0, 'src')\n", "chip_smoke.py:2"),
    ("chip_smoke waived", "check_sys_path", "chip_smoke.py",
     "import sys\nsys.path.insert(0, 'src')  # sys-path: run alone\n", None),
    ("knob without space", "check_tuning_spaces", "src/repro_torch/k.py",
     _VARIANT.format(extra=""), "exposes tuning knob(s) block_k"),
    ("knob with space", "check_tuning_spaces", "src/repro_torch/k.py",
     _VARIANT.format(extra=", tuning=SPACE"), None),
    ("knob waived", "check_tuning_spaces", "src/repro_torch/k.py",
     _VARIANT.format(extra="").replace(
         '"x")', '"x")  # no-tuning: fixed by the caller'), None),
    ("silent broad except", "check_silent_excepts",
     "src/repro_torch/core/e.py",
     "try:\n    x = 1\nexcept Exception:\n    pass\n", "broad silent except"),
    ("bare except", "check_silent_excepts", "src/repro_torch/serving/e.py",
     "try:\n    x = 1\nexcept:\n    pass\n", "broad silent except"),
    ("typed except", "check_silent_excepts", "src/repro_torch/core/e.py",
     "try:\n    x = 1\nexcept (KeyError, ValueError):\n    pass\n", None),
    ("broad except that returns", "check_silent_excepts",
     "src/repro_torch/core/e.py",
     "def f():\n    try:\n        return 1\n    except Exception:\n"
     "        return False\n", None),
]


@pytest.mark.parametrize("case,check,rel,src,want", RULES,
                         ids=[r[0] for r in RULES])
def test_each_rule_reports_its_pattern_and_only_it(tmp_path, case, check,
                                                   rel, src, want):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    found = getattr(_tool(), check)(tmp_path)
    if want is None:
        assert found == [], (case, found)
    else:
        assert len(found) == 1 and want in found[0], (case, found)


@pytest.mark.parametrize("check", ["check_time_time", "check_sys_path",
                                   "check_tuning_spaces",
                                   "check_silent_excepts"])
def test_the_port_is_clean_under_each_rule(check):
    assert getattr(_tool(), check)() == []
