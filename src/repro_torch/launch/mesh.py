"""Mesh builders — the port of the JAX package's ``launch/mesh.py``, with
JAX's mesh shapes, so the sharding rules compare 1:1.  Functions, not
module constants: importing this module starts no process group.

A mesh is a ``torch.distributed`` ``DeviceMesh`` with named dims over the
initialized process group, or an :class:`AbstractMesh`: names and sizes
only, which the sharding rules take without a process group (as JAX's
tests use a fake mesh).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes (``shape``: name -> size)."""
    shape: dict
    axis_names: tuple


def abstract_mesh(shape, axes) -> AbstractMesh:
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    return AbstractMesh(dict(zip(axes, shape)), axes)


def device_type() -> str:
    """``cuda`` under an NCCL process group, else ``cpu`` (gloo, fake)."""
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape, axes):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a DeviceMesh needs an initialized process group "
                           "(torchrun, or init_process_group)")
    n = math.prod(shape)
    if n != dist.get_world_size():
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh: 16x16 = 256 devices per pod; 2 pods = 512."""
    return _mesh(*PRODUCTION_SHAPES[multi_pod])


def make_host_mesh(data: int = 1, model: int = 1):
    """A (data, model) mesh over the initialized process group."""
    return _mesh((data, model), ("data", "model"))
