"""The port's multi-device dry-run (``launch/dryrun.py``), its per-device
step analysis (``launch/step_analysis.py``, the counterpart of the JAX
package's ``hlo_analysis.py``), the roofline and scaling twins and the
sections of ``launch/run.py`` that read the dry-run's JSONL, and the
dry-run's helpers (``shape_applicable``, the ``abstract_*`` inputs)
against the JAX package's."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import shape_applicable as jax_shape_applicable
from repro.models import factory as JF
from repro.runtime import steps as JRS
from repro_torch.configs.base import (ARCH_IDS, SHAPES, get_config,
                                      shape_applicable)
from repro_torch.launch import roofline, run, scaling
from repro_torch.launch.constants import (HBM_BW, INTER_NODE_BW,
                                          MULTI_POD_CHIPS, PEAK_FLOPS_BF16,
                                          SINGLE_POD_CHIPS)
from repro_torch.launch.step_analysis import StepCounter
from repro_torch.models import factory as F
from repro_torch.runtime import steps as RS

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"


def test_step_counter_is_exact_on_a_known_program():
    """5 products of [128, 256] x [256, 256] (the JAX analyzer's
    controlled experiment)."""
    x, w = torch.randn(128, 256), torch.randn(256, 256)
    counter = StepCounter()
    counter.arguments((x, w))
    with counter:
        y = x
        for _ in range(5):
            y = y @ w
    counter.outputs(y)
    assert counter.cost.flops == 5 * 2 * 128 * 256 * 256 == 83_886_080
    assert counter.cost.memory_json()["argument_bytes"] == (128 + 256) * 256 * 4


@pytest.fixture
def fake_256():
    """A 16x16 DeviceMesh over a fake process group of 256 ranks."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import fake_mesh
    mesh = fake_mesh((16, 16), ("data", "model"))
    yield mesh
    dist.destroy_process_group()


def test_local_flops_on_a_16x16_fake_mesh(fake_256):
    """x[256, 64, 5120] Shard(0) @ w[5120, 14336] Shard(1): rank 0's
    product is [16*64, 5120] x [5120, 896]; DTensor's shape inference of
    the global product is not counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with FakeTensorMode():
        dx = DTensor.from_local(torch.empty(16, 64, 5120, dtype=torch.bfloat16),
                                fake_256, [Shard(0), Replicate()],
                                run_check=False)
        dw = DTensor.from_local(torch.empty(5120, 896, dtype=torch.bfloat16),
                                fake_256, [Replicate(), Shard(1)],
                                run_check=False)
        counter = StepCounter()
        counter.arguments((dx, dw))
        with counter:
            y = dx @ dw
        counter.outputs(y)
    assert tuple(y.shape) == (256, 64, 14336)
    assert counter.cost.flops == 2 * 16 * 64 * 5120 * 896 == 9_395_240_960
    assert counter.cost.total_collective_bytes == 0.0


def test_one_all_reduce_counts_twice_its_bytes(fake_256):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Partial, Replicate

    with FakeTensorMode():
        part = DTensor.from_local(torch.empty(1000), fake_256,
                                  [Replicate(), Partial()], run_check=False)
        counter = StepCounter()
        with counter:
            part.redistribute(fake_256, [Replicate(), Replicate()])
    assert counter.cost.collective_counts == {"all-reduce": 1}
    assert counter.cost.collective_bytes == {"all-reduce": 2 * 4000.0}


def test_dryrun_subprocess_smoke(tmp_path):
    """The dry-run entry point on 8 fake devices, reduced config (mirrors
    tests/test_system.py::test_dryrun_subprocess_smoke)."""
    out = tmp_path / "dr.jsonl"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "recurrentgemma-2b", "--shape", "train_4k",
         "--mesh", "single", "--devices", "8", "--mesh-shape", "4,2",
         "--reduced", "--out", str(out)],
        env={**os.environ, "PYTHONPATH": str(SRC)},
        capture_output=True, text=True, timeout=540, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(out.read_text().strip().splitlines()[-1])
    assert rec["status"] == "ok", rec.get("error")
    assert rec["devices"] == 8
    assert rec["hlo_cost"]["flops"] > 0
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["pcfg"]["remat"] == "dots"
    assert rec["collectives"]["total_bytes"] > 0


def test_shape_applicable_equals_jax():
    for arch in ARCH_IDS:
        for name in SHAPES:
            assert shape_applicable(get_config(arch), SHAPES[name]) == \
                jax_shape_applicable(jax_get_config(arch), JAX_SHAPES[name])


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))


def _sds(tree):
    return jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), tree)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "qwen2-72b",
                                  "whisper-small", "paligemma-3b",
                                  "falcon-mamba-7b", "kimi-k2-1t-a32b"])
def test_abstract_inputs_equal_jax(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    assert _meta(F.abstract_params(cfg)) == _sds(JF.abstract_params(jcfg))
    assert _meta(F.abstract_cache(cfg, 4, 64)) == \
        _sds(JF.abstract_cache(jcfg, 4, 64))
    assert _meta(RS.abstract_train_state(cfg)) == \
        _sds(JRS.abstract_train_state(jcfg))
    for name in SHAPES:
        assert _meta(F.batch_spec(cfg, SHAPES[name])) == \
            _sds(JF.batch_spec(jcfg, JAX_SHAPES[name]))
        assert _meta(F.input_specs(cfg, SHAPES[name])) == \
            _sds(JF.input_specs(jcfg, JAX_SHAPES[name]))
    assert all(t.device.type == "meta" for t in
               jax.tree.leaves(F.abstract_params(cfg)))


def _record(arch, shape, mesh, chips, flops, hbm, coll, temp=1e9):
    return {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
            "devices": chips, "reduced": False,
            "memory": {"argument_bytes": 2e9, "output_bytes": 0.0,
                       "temp_bytes": temp},
            "hlo_cost": {"flops": flops, "hbm_bytes": 2 * hbm,
                         "hbm_fused": hbm, "total_collective_bytes": coll}}


@pytest.fixture
def jsonl(tmp_path):
    path = tmp_path / "dryrun.jsonl"
    recs = [
        # compute-bound single pod, its 2-pod twin at half the work
        _record("qwen2-72b", "train_4k", "single", SINGLE_POD_CHIPS,
                2e15, 1e11, 1e9),
        _record("qwen2-72b", "train_4k", "multi", MULTI_POD_CHIPS,
                1e15, 5e10, 4e10),
        # collective-bound decode, single pod only
        _record("arctic-480b", "decode_32k", "single", SINGLE_POD_CHIPS,
                1e9, 1e9, 1e10),
        {"arch": "x", "shape": "train_4k", "mesh": "single",
         "status": "error"},
    ]
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\nnot json\n")
    return path


def test_roofline_terms_and_dominant_term(jsonl):
    rows = {(r["arch"], r["mesh"]): r for r in roofline.load_rows(str(jsonl))}
    assert len(rows) == 3
    q = rows[("qwen2-72b", "single")]
    assert q["compute_s"] == pytest.approx(2e15 / PEAK_FLOPS_BF16)
    assert q["memory_s"] == pytest.approx(1e11 / HBM_BW)
    assert q["memory_raw_s"] == pytest.approx(2e11 / HBM_BW)
    assert q["collective_s"] == pytest.approx(1e9 / INTER_NODE_BW)
    assert q["dominant"] == "compute" and q["step_time_s"] == q["compute_s"]
    cfg = get_config("qwen2-72b")
    mf = 6.0 * cfg.active_param_count() * 256 * 4096
    assert q["model_flops"] == mf
    assert q["roofline_fraction"] == pytest.approx(
        mf / (SINGLE_POD_CHIPS * PEAK_FLOPS_BF16) / q["compute_s"])
    assert q["hbm_gb_per_chip"] == pytest.approx(3.0)
    a = rows[("arctic-480b", "single")]
    assert a["dominant"] == "collective"
    assert INTER_NODE_BW == 50e9           # 400 Gb/s a GPU, one way


def test_scaling_ratio_of_two_pods_to_one(jsonl, capsys):
    out = scaling.main(["--in", str(jsonl)])
    assert len(out) == 1                   # arctic has no 2-pod record
    r = out[0]
    assert (r["arch"], r["shape"]) == ("qwen2-72b", "train_4k")
    assert r["speedup"] == pytest.approx(2.0)
    assert "qwen2-72b" in capsys.readouterr().out


def test_run_sections_read_the_dryrun_jsonl(jsonl, capsys):
    res = run.main(["--section", "roofline", "--dryrun", str(jsonl)])
    assert len(res["roofline"]) == 3
    assert "arctic-480b" in capsys.readouterr().out
    res = run.main(["--section", "scaling", "--dryrun", str(jsonl)])
    assert res["scaling"][0]["speedup"] == pytest.approx(2.0)
    with pytest.raises(SystemExit) as exc:
        run.main(["--section", "roofline"])
    assert exc.value.code != 0
    assert "--dryrun" in capsys.readouterr().err


_PROBE = """
import importlib, sys
names = ["repro_torch.launch." + m for m in ("mesh", "shardings", "dryrun",
         "step_analysis", "roofline", "scaling")]
names += ["repro_torch.parallel.ctx", "repro_torch.parallel.pipeline",
          "repro_torch.optim.compression"]
for name in names:
    importlib.import_module(name)
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib",
                                                           "repro"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_the_multi_device_modules_load_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE],
                          env=dict(os.environ, PYTHONPATH=str(SRC)),
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
