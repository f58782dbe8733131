"""The port's mesh code on 4 CPU ranks over gloo, held against the JAX
package: GPipe stages (``parallel/pipeline.py``) against the sequential
stack and JAX's ``lax.scan`` reference (mirrors tests/test_pipeline.py),
the joint pod x data layout, the Hopper entry points under a mesh (their
plain versions on the CPU), the embedding's backward on a DTensor table
(``layers.embed``'s own, for torch 2.11), the elastic restore of a JAX checkpoint onto
a 2x2 mesh, ``shard_batch``, and reduced qwen2-72b trained on 2x2
against 1x1 (mirrors test_multidevice_training_parity) and 1x1 against no
mesh (tests/test_torch_mesh_families.py runs every family on 2x2).

All of it runs in one spawn of 4 ranks (tests/torch_mesh_worker.py), each
process group and the spawn itself with a time limit.
"""
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint.manager import CheckpointManager as JaxCheckpoints
from repro.configs import get_config as jax_get_config
from repro.runtime import steps as JRS

WORKER = Path(__file__).with_name("torch_mesh_worker.py")
sys.path.insert(0, str(WORKER.parent))
from torch_mesh_worker import run_job  # noqa: E402

L, D, B = 8, 16, 8
# the 1x1 mesh against no mesh: bit for bit (the same local ops)
ONE_BY_ONE_TOL = 0.0
# 2x2 against 1x1, as the JAX package's multi-device parity test
MESH_TOL = 2e-2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    np.savez(out / "pipeline_in.npz",
             w=(rng.standard_normal((L, D, D)) * 0.1).astype(np.float32),
             x=rng.standard_normal((B, D)).astype(np.float32))
    # a JAX train state, saved unsharded by the JAX package
    jstate = JRS.init_train_state(jax_get_config("qwen2-72b").reduced(),
                                  jax.random.PRNGKey(7))
    JaxCheckpoints(str(out / "ckpt")).save(3, jstate)
    run_job("parallel", out)
    return out


def _read(out, name):
    return json.loads((out / name).read_text())


@pytest.mark.parametrize("mb", [2, 4, 8])
def test_pipeline_matches_sequential_and_jax(run, mb):
    assert _read(run, "pipeline.json")[str(mb)] < 1e-6
    data = np.load(run / "pipeline_in.npz")
    unit = lambda c, p: jnp.tanh(c @ p["w"])
    ref, _ = jax.lax.scan(lambda c, p: (unit(c, p), None),
                          jnp.asarray(data["x"]), {"w": jnp.asarray(data["w"])})
    got = np.load(run / f"pipeline_out_{mb}.npy")
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=0)


def test_joint_pod_data_dim_is_laid_out_in_jax_block_order(run):
    res = _read(run, "placements.json")
    assert res["blocks_in_jax_order"]
    assert res["placements"] == ["S0", "S0"]


@pytest.mark.parametrize("kernel", ["flash_attention", "rglru_scan",
                                    "rmsnorm"])
def test_kernel_entry_points_gather_under_a_mesh(run, kernel):
    placements, err = _read(run, "kernels.json")[kernel]
    assert err == 0.0
    assert placements == ["R", "R"]


@pytest.mark.parametrize("layout", ["R/S0", "S1/S0", "S0/S1", "R/R"])
def test_embedding_backward_on_a_dtensor_table_keeps_its_blocks(run, layout):
    res = _read(run, "embed.json")[layout]
    assert res["forward_equal"]
    assert res["grad_err"] < 1e-6
    assert res["placements"] == res["table_placements"] == layout.split("/")


def test_jax_checkpoint_restores_onto_a_2x2_mesh_bit_for_bit(run):
    res = _read(run, "restore.json")
    assert res["bit_equal"] and res["step"] == 3
    assert res["sharded_leaves"] > res["leaves"] // 2


def test_shard_batch_keeps_each_ranks_rows(run):
    assert _read(run, "restore.json")["batch_rows"]


def test_qwen2_on_2x2_matches_1x1(run):
    res = _read(run, "qwen.json")
    a, b = np.asarray(res["1x1"]["losses"]), np.asarray(res["2x2"]["losses"])
    assert len(a) == 5
    np.testing.assert_allclose(a, b, rtol=MESH_TOL, atol=MESH_TOL)
    assert b[-1] < b[0]


def test_1x1_mesh_matches_no_mesh(run):
    res = _read(run, "qwen.json")
    for key in ("losses", "grad_norms"):
        np.testing.assert_allclose(res["1x1"][key], res["none"][key],
                                   rtol=ONE_BY_ONE_TOL, atol=0)
