"""Meshes (PyTorch port), twin of the reference's ``launch/mesh.py``.

Single pod: 16x16 = 256 devices over ("data", "model").
Multi-pod:  2x16x16 = 512 devices over ("pod", "data", "model"): the pod
axis is an outer data axis, which is why batch specs shard over
("pod", "data") jointly.

The production meshes are *abstract*: axis names and sizes, all that the
sharding rules read (``.axis_names``, ``.shape[name]``, ``.size``), so
planning 16x16 or 2x16x16 needs no process group.  ``make_host_mesh`` is a
real ``DeviceMesh`` over the ranks of the current process group.

``mesh_context(mesh, profile)`` makes a ``DeviceMesh`` and a sharding
profile active for the model code's activation constraints
(``models.common.constrain_dims``), in a ``contextvars`` scope that ends
with the ``with`` block; outside it no mesh is active.  It stands for the
reference's ``mesh_context`` together with its module-global profile.
Inside it, plain tensors that meet DTensors count as replicated
(``implicit_replication``), as arrays without a sharding do under the
reference's ``jit``.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

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


@contextmanager
def mesh_context(mesh, profile: str = "tp") -> Iterator:
    """Make ``mesh`` (a ``DeviceMesh``) and ``profile`` ("tp" or "fsdp")
    active for the enclosed code; the outer ones come back on exit."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import common

    assert profile in ("tp", "fsdp")
    outer = DTensor._op_dispatcher._allow_implicit_replication
    tokens = common._MESH.set(mesh), common._PROFILE.set(profile)
    try:
        with implicit_replication():
            yield mesh
    finally:
        DTensor._op_dispatcher._allow_implicit_replication = outer
        common._PROFILE.reset(tokens[1])
        common._MESH.reset(tokens[0])


def replicate(tree, mesh):
    """Every tensor leaf of ``tree`` as a DTensor replicated over ``mesh``,
    over the same buffer (no copy, no collective): each rank holds the whole
    leaf, as the reference's trainer and server hold their state."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.tree import tree_map
    return tree_map(lambda t: DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                                 run_check=False), tree)


def shard_batch(batch, mesh):
    """A global batch that every rank holds whole, as DTensors with the batch
    dim over the data axes of the active profile (``constrain_batch``'s
    placement): each rank keeps its rows, nothing is sent.  Call it inside
    ``mesh_context``."""
    from repro_torch.models.common import constrain_batch
    return {k: constrain_batch(v) for k, v in replicate(batch, mesh).items()}


def gather(tree):
    """Every DTensor leaf of ``tree`` as its full tensor (a collective where
    a leaf is split); other leaves as they are."""
    from repro_torch.models.common import is_dtensor
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.full_tensor() if is_dtensor(t) else t, tree)


def launch_mesh(device: torch.device):
    """For a launcher started by ``torchrun`` (``WORLD_SIZE`` set): the
    default process group (nccl on the card, gloo on the CPU), this rank's
    device and ``make_host_mesh()``.  Without ``torchrun``: ``device`` and
    no mesh."""
    import os

    import torch.distributed as dist

    if "WORLD_SIZE" not in os.environ:
        return device, None
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", device_id=device)
    else:
        dist.init_process_group("gloo")
    return device, make_host_mesh(device.type)


def batch_axes(mesh) -> Tuple[str, ...]:
    """The axes a global batch is sharded over."""
    return tuple(a for a in abstract(mesh).axis_names if a in ("pod", "data"))


def axis_size(mesh, name: str) -> int:
    mesh = abstract(mesh)
    return mesh.shape[name] if name in mesh.axis_names else 1
