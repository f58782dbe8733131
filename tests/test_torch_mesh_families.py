"""Every family of the port on a 2x2 mesh of 4 CPU ranks over gloo (one
arch a family: hybrid, dense, MoE, SSM, VLM, audio): one train step
(the hybrid's under the dots remat), then a prefill and a greedy decode
step on the trained parameters, held against the same steps without the
mesh.  One spawn of tests/torch_mesh_worker.py runs them all."""
import json
import sys
from pathlib import Path

import pytest

WORKER = Path(__file__).with_name("torch_mesh_worker.py")
sys.path.insert(0, str(WORKER.parent))
from torch_mesh_worker import FAMILY_ARCHS, run_job  # noqa: E402


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    out = tmp_path_factory.mktemp("families")
    run_job("families", out)
    return json.loads((out / "families.json").read_text())


def test_the_families_are_one_arch_each():
    from repro_torch.configs.base import get_config
    fams = {get_config(a).family + ("-moe" if get_config(a).is_moe else "")
            for a in FAMILY_ARCHS}
    assert len(fams) == len(FAMILY_ARCHS) == 6


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_every_family_trains_and_serves_on_2x2(families, arch):
    res = families[arch]
    assert res["finite"], res
    assert res["shapes"] == [[4, 1, 256], [4, 1, 256]]
    # the sharded sums round in another order than the whole ones (bf16
    # weights): the logits stay within a small part of their scale
    assert max(res["prefill_err"], res["decode_err"]) < \
        0.05 * res["logit_scale"] + 0.05, res
