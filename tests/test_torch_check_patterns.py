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
