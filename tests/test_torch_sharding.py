"""The port's sharding rules vs the JAX reference's, twins of
tests/test_sharding.py.

Every spec must be valid (divisible, axis-unique) for every arch on the
production meshes and equal ``tuple(PartitionSpec)`` of the reference's
spec leaf by leaf (params and optimizer state of the ten full configs on
16x16 and 2x16x16, the caches of five archs, the batch fallback chain).
The trees are shapes only: the reference's ``jax.eval_shape`` against the
port's meta tensors, so no full-size tree is allocated.  ``placements`` is
checked under a fake process group of 256 (and 512) ranks: the local
shards that ``distribute_tensor`` makes of meta tensors must be the global
shape over the axis sizes.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, AxisType, PartitionSpec as P

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.launch import sharding as jshd
from repro.launch.steps import train_state_shape as jtrain_state_shape
from repro.models import build_model as jbuild_model
from repro.models import lm as jlm
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import (AbstractMesh as TAbstractMesh, axis_size, batch_axes,
                                     make_host_mesh, make_production_mesh)
from repro_torch.launch.steps import train_state_shape
from repro_torch.models import build_model
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig
from repro_torch.tree import tree_leaves, tree_map

# the test workers share the machine's cores (tests/test_system.py times wall clocks)
torch.set_num_threads(2)

J1POD = AbstractMesh((16, 16), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
J2POD = AbstractMesh((2, 16, 16), ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)
MESH_1POD = make_production_mesh()
MESH_2POD = make_production_mesh(multi_pod=True)
MESHES = {"1pod": (MESH_1POD, J1POD), "2pod": (MESH_2POD, J2POD)}
CACHE_ARCHS = ["tinyllama_1_1b", "deepseek_v2_236b", "gemma_2b", "zamba2_1_2b", "rwkv6_7b"]


@lru_cache(maxsize=None)
def _states(arch):
    """(port meta train state, reference train state shapes) of the full config."""
    return (train_state_shape(build_model(get_config(arch)), AdamWConfig()),
            jtrain_state_shape(jbuild_model(jget_config(arch)), JAdamWConfig()))


def _axis_sz(mesh, axis):
    if axis is None:
        return 1
    names = axis if isinstance(axis, tuple) else (axis,)
    n = 1
    for a in names:
        n *= mesh.shape[a]
    return n


def _check_tree(tree, specs, mesh):
    leaves, spec_leaves = tree_leaves(tree), shd.spec_leaves(specs)
    assert len(leaves) == len(spec_leaves)
    for leaf, spec in zip(leaves, spec_leaves):
        assert isinstance(spec, tuple)
        used = []
        assert len(spec) <= leaf.dim()
        for d, axis in enumerate(spec):
            if axis is None:
                continue
            names = axis if isinstance(axis, tuple) else (axis,)
            for nm in names:
                assert nm not in used, (spec, leaf.shape)
                used.append(nm)
            assert leaf.shape[d] % _axis_sz(mesh, axis) == 0, (spec, leaf.shape, d)


def _same_specs(tree, specs, jtree, jspecs):
    """Leaf names and specs equal the reference's, leaf by leaf."""
    got = dict(zip(bridge.leaf_names(tree), shd.spec_leaves(specs)))
    names = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    want = dict(zip(names, (tuple(s) for s in
                            jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, P)))))
    assert len(got) == len(tree_leaves(tree))
    assert got == want


@pytest.mark.parametrize("mesh", ["1pod", "2pod"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_valid_all_archs(arch, mesh):
    """FULL configs: every param and optimizer leaf's spec is valid and is
    the reference's."""
    tmesh, jmesh = MESHES[mesh]
    state, jstate = _states(arch)
    pspecs = shd.param_specs(state["params"], tmesh)
    _check_tree(state["params"], pspecs, tmesh)
    jpspecs = jshd.param_specs(jstate["params"], jmesh)
    _same_specs(state["params"], pspecs, jstate["params"], jpspecs)
    ospecs = shd.opt_state_specs(state["opt"], pspecs, tmesh)
    _check_tree(state["opt"], ospecs, tmesh)
    _same_specs(state["opt"], ospecs, jstate["opt"],
                jshd.opt_state_specs(jstate["opt"], jpspecs, jmesh))


@pytest.mark.parametrize("mesh", ["1pod", "2pod"])
@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_valid(arch, mesh):
    tmesh, jmesh = MESHES[mesh]
    cache = lm.init_cache(get_config(arch), 128, 1024, torch.device("meta"))
    specs = shd.cache_specs(cache, tmesh)
    _check_tree(cache, specs, tmesh)
    jcache = jax.eval_shape(lambda: jlm.init_cache(jget_config(arch), 128, 1024))
    _same_specs(cache, specs, jcache, jshd.cache_specs(jcache, jmesh))


def _at(spec, shape_len, negdim):
    t = tuple(spec) + (None,) * (shape_len - len(tuple(spec)))
    return t[negdim]


def test_model_axis_engaged_for_key_tensors():
    """TP sanity: tinyllama q heads (32) shard over model=16, kv (4) do
    not; granite experts (40) fall back to TP-within-expert."""
    state, _ = _states("tinyllama_1_1b")
    specs = shd.param_specs(state["params"], MESH_1POD)
    assert _at(specs["layers"][0]["attn"]["wq"], 4, -2) == "model"
    assert _at(specs["layers"][0]["attn"]["wk"], 4, -2) is None
    gstate, _ = _states("granite_moe_3b_a800m")
    layer = shd.param_specs(gstate["params"], MESH_1POD)["layers"][0]["ffn"]
    assert _at(layer["wi"], 4, -3) is None and _at(layer["wi"], 4, -1) == "model"


@pytest.mark.parametrize("mesh", ["1pod", "2pod"])
def test_batch_spec_fallback_chain(mesh):
    tmesh, jmesh = MESHES[mesh]
    for B in (256, 128, 1):
        for profile in ("fsdp", "tp"):
            got = shd.batch_specs({"tokens": torch.empty((B, 8), dtype=torch.int32,
                                                         device="meta")}, tmesh, profile)
            want = jshd.batch_specs({"tokens": jax.ShapeDtypeStruct((B, 8), jnp.int32)},
                                    jmesh, profile)
            assert got["tokens"] == tuple(want["tokens"]), (B, profile)
    # M-RoPE positions (3, B, S): the batch dim is the second
    got = shd.batch_specs({"positions": torch.empty((3, 64, 8), device="meta")}, tmesh)
    want = jshd.batch_specs({"positions": jax.ShapeDtypeStruct((3, 64, 8), jnp.int32)}, jmesh)
    assert got["positions"] == tuple(want["positions"])
    if mesh == "1pod":  # the reference test's three readings
        tok = lambda B: shd.batch_specs(
            {"tokens": torch.empty((B, 8), device="meta")}, tmesh, "fsdp")["tokens"][0]
        assert tok(256) == ("data", "model") and tok(128) == "data" and tok(1) is None


def test_embed_not_fsdp_sharded_on_dmodel():
    """The embedding's d_model is never sharded over "data" (the chunked
    loss would all-reduce (B, C, V) logits partial products)."""
    state, _ = _states("gemma_2b")
    emb = shd.param_specs(state["params"], MESH_1POD)["embed"]["tok"]
    assert emb[0] == "model" and (len(emb) < 2 or emb[1] is None)


def test_mesh_axes():
    assert MESH_1POD.size == 256 and MESH_2POD.size == 512
    assert MESH_2POD.shape == {"pod": 2, "data": 16, "model": 16}
    assert batch_axes(MESH_1POD) == ("data",) and batch_axes(MESH_2POD) == ("pod", "data")
    assert axis_size(MESH_1POD, "pod") == 1 and axis_size(MESH_2POD, "pod") == 2
    assert shd.data_axes(MESH_2POD, "fsdp") == ("pod", "data", "model")
    assert shd.shard_count((("pod", "data"), None, "model"), MESH_2POD) == 512


@pytest.fixture(params=["1pod", "2pod"])
def fake_world(request):
    """A fake process group of 256 (512) ranks and its DeviceMesh; torn
    down after the test, since xdist workers run other files after this one."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    mesh = MESHES[request.param][0]
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh.size)
    try:
        yield mesh, DeviceMesh("cpu", torch.arange(mesh.size).reshape(mesh.axis_sizes),
                               mesh_dim_names=mesh.axis_names)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "deepseek_v2_236b", "granite_moe_3b_a800m"])
def test_placements_shard_meta_tensors(fake_world, arch):
    """``distribute`` lays every param leaf out by its spec: each local
    shard is the global shape over the sizes of the axes on each dim."""
    mesh, dmesh = fake_world
    params = _states(arch)[0]["params"]
    specs = shd.param_specs(params, dmesh)
    assert specs == shd.param_specs(params, mesh)  # a DeviceMesh reads as its axes
    dist_params = shd.distribute(params, specs, dmesh)

    def check(t, d, spec):
        want = [n // _axis_sz(mesh, spec[i]) if i < len(spec) else n
                for i, n in enumerate(t.shape)]
        assert tuple(d.shape) == tuple(t.shape)
        assert list(d.to_local().shape) == want, spec

    tree_map(check, params, dist_params, specs)


def test_placements_of_a_tuple_entry(fake_world):
    """A tuple entry shards one tensor dim over several mesh dims."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh, dmesh = fake_world
    spec = shd.batch_specs({"tokens": torch.empty((mesh.size, 8), device="meta")}, mesh,
                           "fsdp")["tokens"]
    assert spec == (mesh.axis_names, None)
    assert shd.placements(spec, dmesh) == [Shard(0)] * len(mesh.axis_names)
    assert shd.placements((None, "model"), dmesh)[-1] == Shard(1)
    assert shd.placements((), dmesh) == [Replicate()] * len(mesh.axis_names)
    local = distribute_tensor(torch.empty((mesh.size, 8), device="meta"), dmesh,
                              shd.placements(spec, dmesh)).to_local()
    assert tuple(local.shape) == (1, 8)


def test_host_mesh_over_the_world(fake_world):
    mesh, _ = fake_world
    hm = make_host_mesh("cpu")
    assert hm.mesh_dim_names == ("data", "model") and tuple(hm.shape) == (mesh.size, 1)
    assert TAbstractMesh(("data", "model"), (mesh.size, 1)).size == mesh.size
