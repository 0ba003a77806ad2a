"""The port's activation constraints vs the JAX reference's.

For the shape roles of every constraint site of the model code, on the
meshes (2,2), (4,1), (1,4) and (1,16) over ("data", "model") and (2,2,2)
over ("pod", "data", "model"), under both profiles: the spec the port's
``constrain_spec`` picks equals the ``PartitionSpec`` the reference's
``constrain_dims`` pins (read from the ``sharding_constraint`` of its
jaxpr, in a subprocess with 16 host devices: the device count is fixed
at JAX's first backend init), and ``constrain_dims`` redistributes a
DTensor to exactly those placements (meta tensors over a fake process
group of the mesh's size).  The shapes include dims the axes do not
divide: MQA's single KV head, 28 heads, granite's 40 experts on 16.  A
plain tensor, and a DTensor outside ``mesh_context``, come back as the
same object.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import mesh_context
from repro_torch.models.common import (constrain_batch, constrain_dims, constrain_spec,
                                       get_sharding_profile, set_sharding_profile,
                                       spec_placements)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent

MESHES = {
    "2x2": ((2, 2), ("data", "model")),
    "4x1": ((4, 1), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "1x16": ((1, 16), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}
HEADS = [(0, "dp"), (2, "model"), (1, "model")]  # q and o: heads, else the sequence
KV = [(0, "dp"), (2, "model")]
HIDDEN = [(0, "dp"), (-1, "model")]
EP = [(0, "model")]
EP_F = [(0, "model"), (2, "model")]
# (site, shape, assignments in the reference's order); widths of the full configs
SITES = {
    "q tinyllama (32 heads)": ((8, 128, 32, 64), HEADS),
    "kv tinyllama (4 kv heads)": ((8, 128, 4, 64), KV),
    "q qwen2-vl (28 heads)": ((8, 128, 28, 128), HEADS),
    "kv mqa (1 kv head)": ((8, 128, 1, 256), KV),
    "o the reference's example": ((4, 6, 8, 16), HEADS),
    "mla q_nope deepseek-v2": ((8, 128, 128, 128), KV),
    "mlp hidden tinyllama": ((8, 128, 5632), HIDDEN),
    "moe expert_in granite (40 experts)": ((40, 512, 1536), EP),
    "moe hidden granite (40 experts)": ((40, 512, 512), EP_F),
    "moe expert_in deepseek-v2 (160 experts)": ((160, 64, 5120), EP),
    "dropless hidden": ((8192, 512), [(1, "model")]),
    "mamba2 xs zamba2": ((8, 128, 64, 64), KV),
    "rwkv6 r": ((8, 128, 4096), KV),
    "logits": ((8, 64, 32000), KV),
    "batch": ((8, 128, 2048), [(0, "dp")]),
    "batch of 1": ((1, 128, 2048), [(0, "dp")]),
    "batch of 6": ((6, 128, 2048), [(0, "dp")]),
}
CASES = [(m, s, p) for m in MESHES for s in SITES for p in ("tp", "fsdp")]

_REFERENCE = r"""
import json, math, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp
from repro.launch.mesh import _axis_type_kwargs, mesh_context
from repro.models import common

out = {}
for key, (shape, names, profile, xshape, assign) in json.load(sys.stdin).items():
    mesh = jax.make_mesh(tuple(shape), tuple(names), devices=jax.devices()[:math.prod(shape)],
                         **_axis_type_kwargs(len(names)))
    common.set_sharding_profile(profile)
    with mesh_context(mesh):
        jaxpr = jax.make_jaxpr(lambda x: common.constrain_dims(x, dict(assign)))(
            jax.ShapeDtypeStruct(tuple(xshape), jnp.float32))
    pinned = [e for e in jaxpr.eqns if e.primitive.name == "sharding_constraint"]
    out[key] = None if not pinned else [
        list(a) if isinstance(a, tuple) else a
        for a in tuple(pinned[0].params["sharding"].spec)] + [None] * (
            len(xshape) - len(pinned[0].params["sharding"].spec))
print(json.dumps(out))
"""


def _key(m, s, p):
    return f"{m}|{s}|{p}"


@pytest.fixture(scope="module")
def reference_specs():
    """Every case's ``PartitionSpec`` from the reference, one subprocess."""
    cases = {_key(m, s, p): (*MESHES[m], p, SITES[s][0], SITES[s][1]) for m, s, p in CASES}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _REFERENCE], input=json.dumps(cases),
                         capture_output=True, text=True, env=env, timeout=240)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def _norm(spec):
    """A spec as the reference's JSON gives it: lists for tuples, trailing
    Nones kept."""
    return None if spec is None else [list(a) if isinstance(a, tuple) else a for a in spec]


class _FakeWorld:
    """A fake process group of the mesh's size, this process rank 0, and
    its ``DeviceMesh``; destroyed on exit (xdist workers run other files
    after this one)."""

    def __init__(self, mesh_key):
        self.shape, self.names = MESHES[mesh_key]

    def __enter__(self):
        from torch.distributed.device_mesh import DeviceMesh
        from torch.testing._internal.distributed.fake_pg import FakeStore

        n = math.prod(self.shape)
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
        return DeviceMesh("cpu", torch.arange(n).reshape(self.shape), mesh_dim_names=self.names)

    def __exit__(self, *exc):
        dist.destroy_process_group()


def _replicated(shape, dmesh):
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(torch.empty(shape, device="meta"), dmesh,
                              [Replicate()] * dmesh.ndim, run_check=False)


@pytest.mark.parametrize("mesh_key,site,profile", CASES)
def test_constraint_spec_equals_reference(reference_specs, mesh_key, site, profile):
    """The port's spec is the reference's, and a DTensor is redistributed
    to its placements (left as it is where nothing is pinned)."""
    shape, assign = SITES[site]
    with _FakeWorld(mesh_key) as dmesh, mesh_context(dmesh, profile):
        spec = constrain_spec(dmesh, shape, dict(assign))
        assert _norm(spec) == reference_specs[_key(mesh_key, site, profile)]
        x = _replicated(shape, dmesh)
        y = constrain_dims(x, dict(assign))
        if spec is None:
            assert y is x
        else:
            assert list(y.placements) == spec_placements(spec, dmesh)
            assert tuple(y.shape) == shape


@pytest.mark.parametrize("site", list(SITES))
def test_placements_follow_the_spec(site):
    """On (2,2,2): each axis the spec names shards its dim, the rest of the
    mesh replicates; axes sharing a dim keep mesh order (major first)."""
    from torch.distributed.tensor import Replicate, Shard

    with _FakeWorld("2x2x2") as dmesh:
        shape, assign = SITES[site]
        for profile in ("tp", "fsdp"):
            with mesh_context(dmesh, profile):
                spec = constrain_spec(dmesh, shape, dict(assign))
            if spec is None:
                continue
            want = [Replicate()] * 3
            for d, names in enumerate(spec):
                for a in (() if names is None else (names,) if isinstance(names, str)
                          else names):
                    want[dmesh.mesh_dim_names.index(a)] = Shard(d)
            assert spec_placements(spec, dmesh) == want


def test_the_reference_example():
    """The (4, 6, 8, 16) example: ('data', None, 'model') under tp and
    (('data', 'model'),) under fsdp on (2,2)."""
    with _FakeWorld("2x2") as dmesh:
        with mesh_context(dmesh, "tp"):
            assert constrain_spec(dmesh, (4, 6, 8, 16), dict(HEADS)) == \
                ("data", None, "model", None)
        with mesh_context(dmesh, "fsdp"):
            assert constrain_spec(dmesh, (4, 6, 8, 16), dict(HEADS)) == \
                (("data", "model"), None, None, None)


def test_plain_tensor_and_no_mesh_are_untouched():
    x = torch.randn(4, 8, 2, 16)
    assert constrain_dims(x, dict(HEADS)) is x and constrain_batch(x) is x
    with _FakeWorld("2x2") as dmesh:
        with mesh_context(dmesh):
            assert constrain_dims(x, dict(HEADS)) is x
        d = _replicated((4, 8, 2, 16), dmesh)
        assert constrain_dims(d, dict(HEADS)) is d  # no mesh active
        with mesh_context(dmesh):
            assert constrain_dims(d, {0: "model"}) is not d
            odd = _replicated((3, 5), dmesh)  # neither dim divides: nothing pinned
            assert constrain_dims(odd, {0: "dp", 1: "model"}) is odd


def test_free_dim_keeps_its_split():
    """The experts' buffers (E, n, D), n split over "data": pinned with E
    on "model" they keep n's split when n is free (the reference's
    vmapped group dim), and are replicated over "data" when it is not."""
    from torch.distributed.tensor import Replicate, Shard

    with _FakeWorld("2x2") as dmesh:
        x = _replicated((8, 32, 16), dmesh).redistribute(dmesh, [Shard(1), Replicate()])
        with mesh_context(dmesh, "tp"):
            assert list(constrain_dims(x, {0: "model"}, free=(1,)).placements) == \
                [Shard(1), Shard(0)]
            assert list(constrain_dims(x, {0: "model"}).placements) == [Replicate(), Shard(0)]
        with mesh_context(dmesh, "fsdp"):  # "model" is a data axis: nothing pinned
            assert constrain_dims(x, {0: "model"}, free=(1,)) is x


def test_profile_is_scoped():
    assert get_sharding_profile() == "tp"
    with _FakeWorld("2x2") as dmesh:
        with mesh_context(dmesh, "fsdp"):
            assert get_sharding_profile() == "fsdp"
            set_sharding_profile("tp")
            assert get_sharding_profile() == "tp"
        assert get_sharding_profile() == "tp"
        with mesh_context(dmesh, "fsdp"):
            with mesh_context(dmesh, "tp"):
                assert get_sharding_profile() == "tp"
            assert get_sharding_profile() == "fsdp"
    assert get_sharding_profile() == "tp"
