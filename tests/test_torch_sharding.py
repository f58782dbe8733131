"""The port's sharding rules (``parallel/rules.py``, ``launch/mesh.py``,
``launch/shardings.py``) against the JAX package's: the spec of every leaf
of every arch's full-width parameter and cache templates on the 16x16 and
2x16x16 production meshes under each preset, the fallback cases of
tests/test_substrates.py, FSDP, the multi-pod batch, the kv-cache ctx
fallback and the divisibility property; and the DTensor placements a spec
becomes.  Pure Python: no process group."""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.models.params import ParamSpec as JaxParamSpec
from repro.parallel import presets as jpresets
from repro.parallel.rules import ParallelismConfig as JaxPcfg
from repro.parallel.rules import partition_spec as jax_partition_spec
from repro_torch.configs.base import ARCH_IDS, BONUS_ARCH_IDS, SHAPES
from repro_torch.configs.base import get_config
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import PRODUCTION_SHAPES, abstract_mesh
from repro_torch.models import lm
from repro_torch.parallel import presets
from repro_torch.parallel.rules import (ParallelismConfig, batch_shardings,
                                        local_shape, partition_spec,
                                        placements)

ARCHS = ARCH_IDS + BONUS_ARCH_IDS


class _FakeMesh:
    """The JAX rules' view of a mesh (tests/test_substrates.py)."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _meshes():
    for multi in (False, True):
        shape, axes = PRODUCTION_SHAPES[multi]
        yield _FakeMesh(dict(zip(axes, shape))), abstract_mesh(shape, axes)


def _pairs(jtree, ttree, path=""):
    """(path, JAX ParamSpec, port ParamSpec) of two templates, leaf by
    leaf; the two trees must have the same keys."""
    if isinstance(jtree, JaxParamSpec):
        yield path, jtree, ttree
        return
    assert sorted(jtree) == sorted(ttree), path
    for k in jtree:
        yield from _pairs(jtree[k], ttree[k], f"{path}/{k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_partition_spec_of_every_leaf_equals_jax(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    trees = [(jlm.model_template(jcfg), lm.model_template(tcfg), "weight")]
    for name in ("decode_32k", "prefill_32k"):
        b, s = SHAPES[name].global_batch, SHAPES[name].seq_len
        trees.append((jlm.cache_template(jcfg, b, s),
                      lm.cache_template(tcfg, b, s), "cache"))
    n = 0
    for jmesh, tmesh in _meshes():
        model = tmesh.shape["model"]
        for shape in SHAPES:
            jp = jpresets.parallelism_for(jcfg, JAX_SHAPES[shape],
                                          model_axis=model)
            tp = presets.parallelism_for(tcfg, SHAPES[shape],
                                         model_axis=model)
            assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
            for jt, tt, kind in trees:
                for path, js, ts in _pairs(jt, tt):
                    assert (ts.shape, ts.axes) == (js.shape, js.axes), path
                    want = tuple(jax_partition_spec(js.shape, js.axes, jmesh,
                                                    jp, kind))
                    got = partition_spec(ts.shape, ts.axes, tmesh, tp, kind)
                    assert got == want, (path, kind, shape)
                    n += 1
    assert n > 100


@pytest.mark.parametrize("shape,axes,expect", [
    ((1024, 4096), ("vocab", "embed"), ("model", None)),
    ((4096, 1120), ("embed", "mlp"), (None, "model")),     # 1120 % 16 = 0
    ((4096, 1000), ("embed", "mlp"), (None, None)),        # not divisible
    ((10, 64), ("heads", None), (None, None)),             # 10 % 16 != 0
    ((256, 4096), ("batch", "seq"), ("data", None)),
])
def test_partition_spec_divisibility_fallback(shape, axes, expect):
    mesh = abstract_mesh((16, 16), ("data", "model"))
    assert partition_spec(shape, axes, mesh, ParallelismConfig()) == expect
    assert tuple(jax_partition_spec(shape, axes, _FakeMesh(mesh.shape),
                                    JaxPcfg())) == expect


def test_partition_spec_fsdp_shards_embed():
    mesh = abstract_mesh((16, 16), ("data", "model"))
    spec = partition_spec((4096, 1024), ("embed", "mlp"), mesh,
                          ParallelismConfig(fsdp=True))
    assert spec == ("data", "model")
    multi = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert partition_spec((4096, 1024), ("embed", "mlp"), multi,
                          ParallelismConfig(fsdp=True)) == \
        (("pod", "data"), "model")


def test_partition_spec_multi_pod_batch():
    mesh = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    spec = partition_spec((256, 4096), ("batch", "seq"), mesh,
                          ParallelismConfig())
    assert spec[0] == ("pod", "data")


def test_kv_cache_ctx_fallback_when_heads_unshardable():
    mesh = abstract_mesh((16, 16), ("data", "model"))
    spec = partition_spec((128, 8, 32768, 128),
                          ("batch", "kv_heads", "ctx", None), mesh,
                          ParallelismConfig(), kind="cache")
    assert spec[1] is None and spec[2] == "model"


@settings(max_examples=30, deadline=None)
@given(dim0=st.integers(1, 4096), dim1=st.integers(1, 4096))
def test_partition_spec_never_breaks_divisibility(dim0, dim1):
    mesh = abstract_mesh((16, 16), ("data", "model"))
    spec = partition_spec((dim0, dim1), ("vocab", "mlp"), mesh,
                          ParallelismConfig())
    for size, entry in zip((dim0, dim1), spec):
        if entry is not None:
            axes = entry if isinstance(entry, tuple) else (entry,)
            assert size % int(np.prod([mesh.shape[a] for a in axes])) == 0
    assert spec == tuple(jax_partition_spec(
        (dim0, dim1), ("vocab", "mlp"), _FakeMesh(mesh.shape), JaxPcfg()))


class _Names:
    """What placements() reads of a DeviceMesh: its dim names."""

    def __init__(self, *names):
        self.mesh_dim_names = names
        self.shape = (2,) * len(names)


def test_placements_shard_a_joint_dim_on_both_mesh_dims():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _Names("pod", "data", "model")
    assert placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert placements((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        placements((("data", "pod"),), mesh)
    assert local_shape((64, 8, 32), (("pod", "data"), None, "model"),
                       mesh) == (16, 8, 16)


def test_step_shardings_cover_their_trees():
    cfg = get_config("qwen2-72b")
    mesh = abstract_mesh((16, 16), ("data", "model"))
    pcfg = presets.parallelism_for(cfg, SHAPES["decode_32k"])
    (p_sh, cache_sh, tok, pos), (logits, cache_out) = SH.serve_shardings(
        cfg, SHAPES["decode_32k"], mesh, pcfg)
    assert tok.spec == ("data", None) and pos.spec == ("data",)
    assert logits.spec == ("data", None, "model")
    assert cache_out == cache_sh
    assert p_sh["embed"].spec == ("model", None)
    (state_sh, batch_sh), (_, metrics) = SH.train_shardings(
        cfg, SHAPES["train_4k"], mesh, pcfg)
    assert state_sh["opt"]["m"] == state_sh["params"]
    assert batch_sh["tokens"].spec == ("data", None)
    assert metrics["loss"].spec == ()
    odd = batch_shardings({"x": np.zeros((10, 3))}, mesh, pcfg)
    assert odd["x"].spec == (None, None)
