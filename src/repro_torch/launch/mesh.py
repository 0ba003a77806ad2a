"""Meshes (PyTorch port), twin of the reference's ``launch/mesh.py``.

Single pod: 16x16 = 256 devices over ("data", "model").
Multi-pod:  2x16x16 = 512 devices over ("pod", "data", "model"): the pod
axis is an outer data axis, which is why batch specs shard over
("pod", "data") jointly.

The production meshes are *abstract*: axis names and sizes, all that the
sharding rules read (``.axis_names``, ``.shape[name]``, ``.size``), so
planning 16x16 or 2x16x16 needs no process group.  ``make_host_mesh`` is a
real ``DeviceMesh`` over the ranks of the current process group.

The reference's ``mesh_context`` is not ported: it installs the mesh that
``jit`` lowers against, and eager torch has no such context (a DTensor
carries its mesh).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch


@dataclass(frozen=True)
class AbstractMesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def abstract(mesh) -> AbstractMesh:
    """The axes of an ``AbstractMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh
    return AbstractMesh(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def make_host_mesh(device_type: str = "cuda"):
    """A ``DeviceMesh`` of shape (n, 1) over ("data", "model"), n the
    world size of the default process group (which must be initialised):
    one card a rank."""
    from torch.distributed.device_mesh import DeviceMesh

    n = torch.distributed.get_world_size()
    return DeviceMesh(device_type, torch.arange(n).reshape(n, 1),
                      mesh_dim_names=("data", "model"))


def batch_axes(mesh) -> Tuple[str, ...]:
    """The axes a global batch is sharded over."""
    return tuple(a for a in abstract(mesh).axis_names if a in ("pod", "data"))


def axis_size(mesh, name: str) -> int:
    mesh = abstract(mesh)
    return mesh.shape[name] if name in mesh.axis_names else 1
