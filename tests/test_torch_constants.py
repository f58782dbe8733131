"""``repro_torch.launch.constants``: the H100's figures in one place, and
``projected_seconds`` computing what the JAX package's
``projected_tpu_seconds`` computes when both are given the same peaks."""
import ast
import re
from pathlib import Path

import pytest

from repro.launch import constants as JC
from repro_torch.core import cost_model as TCM
from repro_torch.core import resources as TR
from repro_torch.launch import constants as TC

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("flops,hbm,trans", [
    (1e12, 1e9, 0.0), (1e9, 4e11, 0.0), (1e6, 1e3, 1e12), (0.0, 0.0, 0.0),
    (8 * 64 * 4096 * 128, 8 * 64 * (2 * 4096 + 128), 0.0)])
def test_projected_seconds_agrees_with_the_jax_twin(monkeypatch, flops, hbm,
                                                    trans):
    monkeypatch.setattr(JC, "PEAK_FLOPS_BF16", TC.PEAK_FLOPS_BF16)
    monkeypatch.setattr(JC, "HBM_BW", TC.HBM_BW)
    monkeypatch.setattr(JC, "TRANSCENDENTAL_RATE", TC.SFU_RATE)
    want = JC.projected_tpu_seconds(flops, hbm, trans)
    got = TC.projected_seconds(flops, hbm, trans)
    for term in ("compute", "memory", "transcendental", "seconds"):
        assert got[term] == pytest.approx(want[term], rel=1e-12, abs=0.0)
    if flops or hbm or trans:
        assert got["bound"] == want["bound"]
    assert want["collective"] == 0.0 and "collective" not in got


def test_the_published_h100_figures():
    assert TC.PEAK_FLOPS_BF16 == 989e12 and TC.PEAK_FLOPS_FP32 == 67e12
    assert TC.HBM_BW == 3.35e12 and TC.HBM_BYTES == 80 * 1024**3
    assert TC.SFU_RATE == TC.PEAK_FLOPS_FP32 / 16
    assert TC.SMEM_PER_BLOCK == 232_448 and TC.L2_BYTES == 50 * 1024**2
    # float32 work at the FP32 peak, transcendentals at the SFU rate
    p = TC.projected_seconds(67e12, 0.0, peak_flops=TC.PEAK_FLOPS_FP32)
    assert p["seconds"] == pytest.approx(1.0) and p["bound"] == "compute"
    p = TC.projected_seconds(0.0, 0.0, TC.SFU_RATE * 2)
    assert p["seconds"] == pytest.approx(2.0)
    assert p["bound"] == "transcendental"


def test_the_tf32_peak_is_the_data_sheets_and_bounds_the_float32_flash():
    """Dense TF32 at 495 TFLOP/s; the float32 flash runs each product as
    three TF32 ones, so chip_smoke.py's bound for it reads this figure."""
    assert TC.PEAK_FLOPS_TF32 == 495e12
    assert TC.PEAK_FLOPS_FP32 < TC.PEAK_FLOPS_TF32 / 3 < TC.PEAK_FLOPS_BF16
    assert "PEAK_FLOPS_TF32" in _imports_from_constants(ROOT / "chip_smoke.py")
    assert not re.search(r"\b495(\.0)?e12\b", "\n".join(
        line for line in (ROOT / "chip_smoke.py").read_text().splitlines()
        if not line.lstrip().startswith("#")))


def test_the_readers_take_their_figures_from_the_module():
    assert TCM.ACCEL_FLOPS == TC.PEAK_FLOPS_BF16
    assert TCM.ACCEL_BW == TC.HBM_BW
    assert TCM.ACCEL_TRANSCENDENTAL_RATE == TC.SFU_RATE
    assert TR.SMEM_PER_BLOCK == TC.SMEM_PER_BLOCK
    assert TR.L2_BYTES == TC.L2_BYTES


def _imports_from_constants(path: Path) -> set:
    tree = ast.parse(path.read_text())
    return {a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
            and n.module == "repro_torch.launch.constants" for a in n.names}


@pytest.mark.parametrize("path,names", [
    ("src/repro_torch/core/cost_model.py",
     {"PEAK_FLOPS_BF16", "HBM_BW", "SFU_RATE"}),
    ("src/repro_torch/core/resources.py", {"L2_BYTES", "SMEM_PER_BLOCK"}),
    ("src/repro_torch/kernels/__init__.py", {"SMEM_PER_BLOCK"}),
    ("chip_smoke.py",
     {"HBM_BW", "PEAK_FLOPS_BF16", "PEAK_FLOPS_FP32", "SFU_RATE"})])
def test_the_readers_import_the_one_module(path, names):
    """An AST check: nothing of chip_smoke.py is imported here."""
    assert names <= _imports_from_constants(ROOT / path)


def test_the_cost_models_sfu_seed_is_a_sixteenth_of_fp32():
    assert TCM.ACCEL_TRANSCENDENTAL_RATE == 67e12 / 16 == 4.1875e12


# the figures as a literal in any spelling: 989e12, 3.35e12, 67e12,
# 232_448 / 232448, 4.19e12
_LITERAL = re.compile(r"\b(989e12|989\.0e12|3\.35e12|67e12|67\.0e12|"
                      r"232_?448|4\.19e12)\b")


def test_the_peaks_are_written_in_one_place_only():
    sources = sorted((ROOT / "src/repro_torch").rglob("*.py"))
    sources.append(ROOT / "chip_smoke.py")
    found = {str(p.relative_to(ROOT)) for p in sources
             if _LITERAL.search("\n".join(
                 line for line in p.read_text().splitlines()
                 if not line.lstrip().startswith("#")))}
    assert found == {"src/repro_torch/launch/constants.py"}
