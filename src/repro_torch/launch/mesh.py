"""Meshes: the JAX package's ``launch/mesh.py`` for torch.

A torch ``DeviceMesh`` needs its ranks to exist, so a mesh here is a
description, not live ranks: a frozen :class:`MeshSpec` of logical shape
and axis names.  The production meshes keep the JAX package's shapes and
axis names, so a parameter's partition spec (``LMBase.param_specs``)
names the same axes and its shard shape
(``repro_torch.launch.steps.NamedSharding.shard_shape``) is the one JAX
computes.  :meth:`MeshSpec.device_mesh` turns a description into a live
``DeviceMesh``, and only inside launched ranks of its world size.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh as its logical shape and axis names."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axis names "
                             f"{self.axis_names} differ in length")

    @property
    def size(self) -> int:
        """The number of devices (ranks) of the mesh."""
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def device_mesh(self, device_type: str = "cuda"):
        """The live ``DeviceMesh`` of this shape and these axis names
        (``init_device_mesh``).  Valid only inside launched ranks of
        ``size`` (an initialised ``torch.distributed`` world of that
        size); raises otherwise."""
        import torch.distributed as dist
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                f"MeshSpec{self.shape}.device_mesh() needs launched ranks: "
                f"torch.distributed is not initialised")
        if dist.get_world_size() != self.size:
            raise RuntimeError(
                f"MeshSpec{self.shape} needs {self.size} ranks, the world "
                f"has {dist.get_world_size()}")
        from torch.distributed.device_mesh import init_device_mesh
        return init_device_mesh(device_type, self.shape,
                                mesh_dim_names=self.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The JAX package's 16x16 pod over ("data", "model"); the multi-pod
    mesh adds a leading 2-pod data-parallel axis (512 devices)."""
    if multi_pod:
        return MeshSpec((2, 16, 16), ("pod", "data", "model"))
    return MeshSpec((16, 16), ("data", "model"))


def make_smoke_mesh(data: int = 1, model: int = 1) -> MeshSpec:
    """A small mesh over the ranks the process has; ``(1, 1)`` is one card
    (the ``card`` mesh)."""
    return MeshSpec((data, model), ("data", "model"))


#: mesh name -> multi_pod (the partition specs' flag)
MESH_NAMES = {"card": False, "pod": False, "multipod": True}


def mesh_for(name: str) -> MeshSpec:
    """The mesh a name of :data:`MESH_NAMES` stands for."""
    if name == "card":
        return make_smoke_mesh()
    return make_production_mesh(multi_pod=MESH_NAMES[name])
