"""The port's dry-run vs the JAX reference's, on the CPU.

* resident bytes per device of every cell of ``cells()`` on both
  production meshes equal the reference's formula over the reference's
  own shapes and specs (its ``_resident_bytes_per_device``, recomputed
  here: importing ``repro.launch.dryrun`` would set ``XLA_FLAGS`` to 512
  host devices for every later test in the worker);
* the meta inputs equal the reference's: train state (and a CPU-initialised
  state), batch specs and ``concrete_batch`` values, decode caches;
* a smoke-config report has the reference's report keys (read from the
  reference's source), and the traced temporary bytes follow the tensors'
  lifetimes;
* the CLI exits 0 on a cell and 1, listing it, on a failing one.
"""

import ast
import json
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType, PartitionSpec as P

from _torch_twins import with_reference_rope_and_routing
from repro.analysis.hlo import HloSummary
from repro.configs import SHAPES as JSHAPES
from repro.configs import cells as jcells
from repro.configs import get_config as jget_config
from repro.launch import sharding as jshd
from repro.launch.specs import concrete_batch as jconcrete_batch
from repro.launch.specs import input_specs as jinput_specs
from repro.launch.steps import train_state_shape as jtrain_state_shape
from repro.models import build_model as jbuild_model
from repro.models import lm as jlm
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro_torch import bridge
from repro_torch.analysis.cost import trace_costs
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeSpec, cells, get_config
from repro_torch.launch.dryrun import make_cell, plan, resident_on, trace_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import concrete_batch, decode_specs, input_specs
from repro_torch.launch.steps import make_train_state, train_state_shape
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.tree import tree_leaves

# the test workers share the machine's cores (tests/test_system.py times wall clocks)
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
JMESHES = {
    "16x16": AbstractMesh((16, 16), ("data", "model"), axis_types=(AxisType.Auto,) * 2),
    "2x16x16": AbstractMesh((2, 16, 16), ("pod", "data", "model"),
                            axis_types=(AxisType.Auto,) * 3),
}
MESHES = {"16x16": make_production_mesh(), "2x16x16": make_production_mesh(multi_pod=True)}


def _jresident(sds_trees, spec_trees, mesh) -> int:
    """The reference's ``_resident_bytes_per_device`` (launch/dryrun.py:59)."""
    total = 0
    for sds_tree, spec_tree in zip(sds_trees, spec_trees):
        leaves = jax.tree.leaves(sds_tree)
        specs = jax.tree.leaves(spec_tree, is_leaf=lambda x: isinstance(x, P))
        for leaf, spec in zip(leaves, specs):
            frac = 1
            for axis in tuple(spec):
                if axis is None:
                    continue
                for a in (axis if isinstance(axis, tuple) else (axis,)):
                    frac *= mesh.shape[a]
            total += leaf.size * leaf.dtype.itemsize // frac
    return total


@lru_cache(maxsize=None)
def _jparams(arch):
    model = jbuild_model(jget_config(arch))
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0))


@lru_cache(maxsize=None)
def _jstate(arch):
    return jtrain_state_shape(_jparams(arch)[0], JAdamWConfig())


@lru_cache(maxsize=None)
def _jcache(arch, shape_name):
    """The reference dry-run's serve-time cache (launch/dryrun.py:168-184)."""
    model, params = _jparams(arch)
    cfg, shape = model.cfg, JSHAPES[shape_name]
    if model.is_enc_dec:
        pre = {"tokens": jax.ShapeDtypeStruct((shape.global_batch, 8), jnp.int32),
               "frames": jax.ShapeDtypeStruct(
                   (shape.global_batch, cfg.enc_dec.n_audio_ctx, cfg.d_model), jnp.bfloat16)}
        return jax.eval_shape(lambda p, b: model.prefill(p, b, shape.seq_len), params, pre)[1]
    return jax.eval_shape(lambda: jlm.init_cache(cfg, shape.global_batch, shape.seq_len))


def _jresident_cell(arch, shape_name, mesh):
    """Resident bytes as the reference's ``lower_cell`` computes them."""
    model, params = _jparams(arch)
    cfg, shape = model.cfg, JSHAPES[shape_name]
    profile = cfg.sharding_profile if shape.kind == "train" else "tp"
    if shape.kind == "train":
        state, batch = _jstate(arch), jinput_specs(cfg, shape)
        ps = jshd.param_specs(state["params"], mesh)
        sspecs = {"params": ps, "opt": jshd.opt_state_specs(state["opt"], ps, mesh)}
        return _jresident([state, batch], [sspecs, jshd.batch_specs(batch, mesh, profile)], mesh)
    ps = jshd.param_specs(params, mesh)
    if shape.kind == "prefill":
        batch = jinput_specs(cfg, shape)
        return _jresident([params, batch], [ps, jshd.batch_specs(batch, mesh, profile)], mesh)
    cache = _jcache(arch, shape_name)
    return _jresident([params, cache], [ps, jshd.cache_specs(cache, mesh, profile)], mesh)


def _shapes(tree):
    return [(tuple(x.shape), str(x.dtype).split(".")[-1]) for x in tree_leaves(tree)]


def _jshapes(tree):
    return [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(tree)]


def _jnames(tree):
    return [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_cells_are_the_reference_cells():
    assert cells() == jcells() and len(cells()) == 32
    assert cells(include_skipped=True) == jcells(include_skipped=True)
    assert {k: tuple(vars(v).values()) for k, v in SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch,shape", jcells())
def test_resident_bytes_equal_reference_formula(arch, shape):
    cell = make_cell(arch, shape)
    for name, mesh in MESHES.items():
        assert resident_on(cell, mesh) == _jresident_cell(arch, shape, JMESHES[name]), name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_inputs_equal_reference(arch):
    """Train state, batch and decode inputs: leaf names, shapes, dtypes."""
    cfg = with_reference_rope_and_routing(get_config(arch))
    state, jstate = train_state_shape(build_model(cfg), AdamWConfig()), _jstate(arch)
    assert bridge.leaf_names(state) == _jnames(jstate)
    assert _shapes(state) == _jshapes(jstate)
    assert all(x.is_meta for x in tree_leaves(state))
    for name, shape in SHAPES.items():
        got, want = input_specs(cfg, shape), jinput_specs(jget_config(arch), JSHAPES[name])
        assert bridge.leaf_names(got) == _jnames(want)
        assert _shapes(got) == _jshapes(want)
    tok, pos = decode_specs(cfg, SHAPES["decode_32k"])
    assert tok.shape == pos.shape == (128,) and tok.dtype == pos.dtype == torch.int32


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_cache_equals_reference(arch):
    cell = make_cell(arch, "decode_32k")
    want = _jcache(arch, "decode_32k")
    assert bridge.leaf_names(cell.trees["cache"]) == _jnames(want)
    assert _shapes(cell.trees["cache"]) == _jshapes(want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_train_state_matches_cpu_init(arch):
    """The meta tree has the leaves of a state initialised on the CPU."""
    model = build_model(get_config(arch, smoke=True))
    meta = train_state_shape(model, AdamWConfig())
    real = make_train_state(model, AdamWConfig(), torch.Generator().manual_seed(0))
    assert bridge.leaf_names(meta) == bridge.leaf_names(real)
    assert _shapes(meta) == _shapes(real)
    assert all(x.device.type == "cpu" for x in tree_leaves(real))


@pytest.mark.parametrize("arch", ["qwen2_vl_7b", "whisper_tiny", "tinyllama_1_1b"])
def test_concrete_batch_equals_reference(arch):
    shape = ShapeSpec("t", 300, 2, "train")
    got = concrete_batch(get_config(arch, smoke=True), shape, np.random.default_rng(3))
    want = jconcrete_batch(jget_config(arch, smoke=True), shape, np.random.default_rng(3))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _reference_report_keys():
    """The keys of the report the reference's ``run_cell`` writes, read
    from its source, with ``HloSummary``'s."""
    tree = ast.parse((ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text())
    node = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "report")
    keys = {k.value: ({kk.value for kk in v.keys} if isinstance(v, ast.Dict) else None)
            for k, v in zip(node.keys, node.values)}
    keys["hlo"] = set(HloSummary().to_dict())
    return keys


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_smoke_report_has_reference_keys(kind):
    cell = trace_cell(make_cell("granite_moe_3b_a800m", ShapeSpec(kind, 64, 2, kind),
                                smoke=True))
    report = plan(cell, make_production_mesh())
    json.dumps(report)
    for key, sub in _reference_report_keys().items():
        assert key in report
        if sub is not None:
            assert sub <= set(report[key]), key
    mem = report["memory"]
    assert mem["resident_bytes_per_device"] > 0 and mem["temp_bytes_per_device"] > 0
    assert report["hlo"]["dot_flops"] > 0 and report["hlo"]["collective_bytes"] is None
    assert report["roofline"]["collective_s"] is None
    assert report["roofline"]["bound_s"] == max(report["roofline"]["compute_s"],
                                                report["roofline"]["memory_s"])


def test_traced_temporaries_follow_lifetimes():
    """Peak and end bytes count only what the call allocates, while it
    lives; writes into an input allocate nothing."""
    x = torch.empty(256, 256, device="meta")  # 256 KiB
    one = 256 * 256 * 4

    def f(x):
        y = x * 2
        z = y + 1          # y and z: 2 units
        del y
        x.add_(1)          # in place on an input: nothing
        return z * 3       # z and the result: 2 units; the result outlives f

    out, s = trace_costs(f, x)
    assert s.peak_bytes == 2 * one and s.end_bytes == one
    del out


def _cli(*args, tmp):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                           "--out", str(tmp)], env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_writes_reports_and_fails_loudly(tmp_path):
    res = _cli("--arch", "zamba2-1.2b", "--shape", "long_500k", "--both-meshes", tmp=tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "zamba2_1_2b__long_500k__16x16.json", "zamba2_1_2b__long_500k__2x16x16.json"]
    rep = json.loads((tmp_path / "zamba2_1_2b__long_500k__16x16.json").read_text())
    assert rep["devices"] == 256 and rep["profile"] == "tp"
    res = _cli("--arch", "zamba2-1.2b", "--shape", "no_such_shape", tmp=tmp_path)
    assert res.returncode == 1
    assert "1 FAILURES" in res.stdout and "no_such_shape" in res.stdout


def test_cli_counts_collectives(tmp_path):
    """A decode cell gets the mesh trace: the report's collective fields
    and the roofline's collective term are filled, and the line says so."""
    res = _cli("--arch", "tinyllama-1.1b", "--shape", "decode_32k", tmp=tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    rep = json.loads((tmp_path / "tinyllama_1_1b__decode_32k__16x16.json").read_text())
    assert rep["hlo"]["collective_count"] > 0 and rep["roofline"]["collective_s"] > 0
    assert rep["mesh_trace_s"] > 0 and "coll/dev=" in res.stdout


def test_prefill_cells_state_why_collectives_are_null():
    """The CLI traces train and decode cells over a mesh; a prefill cell's
    report keeps null collective fields and says why."""
    from repro_torch.launch.dryrun import MESH_TRACED, PREFILL_REASON

    cell = trace_cell(make_cell("tinyllama_1_1b", ShapeSpec("prefill", 64, 4, "prefill"),
                                smoke=True))
    report = plan(cell, make_production_mesh())
    assert report["hlo"]["collective_bytes"] is None and report["mesh_trace_s"] is None
    assert report["hlo"]["collective_reason"] == PREFILL_REASON
    assert MESH_TRACED == ("train", "decode")


# ---------------------------------------------------------------------------
# collectives counted over a fake mesh (launch.dryrun.trace_mesh)
# ---------------------------------------------------------------------------
def _on(shape, dmesh, placements):
    """A meta DTensor of global ``shape``: rank 0's shard."""
    from torch.distributed.tensor import DTensor, Shard

    local = list(shape)
    for n, p in zip(dmesh.shape, placements):
        if isinstance(p, Shard):
            local[p.dim] //= n
    return DTensor.from_local(torch.empty(local, device="meta"), dmesh, placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


@pytest.fixture
def fake(request):
    """``fake_mesh`` of the given axes; its group destroyed after the test."""
    from repro_torch.launch.dryrun import fake_mesh
    from repro_torch.launch.mesh import AbstractMesh

    names = ("data", "model") if len(request.param) == 2 else ("pod", "data", "model")
    try:
        yield fake_mesh(AbstractMesh(names, request.param))
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("fake", [(1, 1)], indirect=True)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_one_device_mesh_counts_no_collectives(fake, kind):
    from repro_torch.launch.dryrun import trace_mesh

    cell = trace_cell(make_cell("tinyllama_1_1b", ShapeSpec(kind, 64, 4, kind), smoke=True))
    trace_mesh(cell, fake)
    by_kind, count, _ = cell.collectives["1x1"]
    assert count == 0 and set(by_kind.values()) == {0.0}
    report = plan(cell, fake)
    assert report["hlo"]["collective_bytes"] == 0.0 and report["hlo"]["collective_count"] == 0
    assert report["roofline"]["collective_s"] == 0.0


@pytest.mark.parametrize("fake", [(1, 16)], indirect=True)
def test_tp_mlp_is_one_all_reduce(fake):
    """Megatron's MLP under tp on (1,16): the ffn dim split over "model" in
    both products, one all-reduce of the (B, S, D) output, nothing else."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.analysis.cost import trace_collectives
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models import mlp

    cfg = get_config("tinyllama_1_1b", smoke=True)
    B, S, D, F = 4, 64, cfg.d_model, cfg.d_ff
    R = Replicate()
    p = {"wi": _on((D, F), fake, [R, Shard(1)]), "wg": _on((D, F), fake, [R, Shard(1)]),
         "wo": _on((F, D), fake, [R, Shard(0)])}
    x = _on((B, S, D), fake, [R, R])
    with mesh_context(fake, "tp"):
        y, by_kind, count = trace_collectives(
            lambda: mlp.mlp_apply(cfg, p, x).redistribute(fake, [R, R]))
    assert count == 1 and by_kind["all-reduce"] == B * S * D * 4
    assert sum(by_kind.values()) == by_kind["all-reduce"] and tuple(y.shape) == (B, S, D)


@pytest.mark.parametrize("fake", [(16, 1)], indirect=True)
def test_fsdp_param_all_gather(fake):
    """An fsdp param, (D, F) split over "data" on (16,1), gathered whole:
    one all-gather whose result is the whole param, D * F * 4 bytes."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.analysis.cost import trace_collectives
    from repro_torch.launch.mesh import mesh_context

    D, F = 2048, 5632
    w = _on((D, F), fake, [Shard(0), Replicate()])
    with mesh_context(fake, "fsdp"):
        full, by_kind, count = trace_collectives(
            lambda: w.redistribute(fake, [Replicate(), Replicate()]))
    assert count == 1 and by_kind["all-gather"] == D * F * 4
    assert sum(by_kind.values()) == D * F * 4 and tuple(full.to_local().shape) == (D, F)


@pytest.mark.parametrize("fake", [(16, 1)], indirect=True)
def test_all_to_all_counted_as_one(fake):
    """A shard moved from dim 0 to dim 1 over 16 ranks is one all-to-all of
    its own result bytes (16 x 2 floats), not the all-gather and chunk that
    DTensor falls back to on a CPU mesh outside the trace."""
    from torch.distributed.tensor import Replicate, Shard, placement_types

    from repro_torch.analysis.cost import trace_collectives

    fallback = placement_types.shard_dim_alltoall
    x = _on((16, 32), fake, [Shard(0), Replicate()])
    y, by_kind, count = trace_collectives(lambda: x.redistribute(fake, [Shard(1), Replicate()]))
    assert count == 1 and by_kind["all-to-all"] == 16 * 2 * 4 and by_kind["all-gather"] == 0
    assert tuple(y.to_local().shape) == (16, 2)
    assert placement_types.shard_dim_alltoall is fallback  # put back after the trace


@pytest.mark.parametrize("fake", [(2, 2)], indirect=True)
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_mesh_trace_adds_only_collectives(fake, kind):
    """The report's FLOP and byte fields are the meshless trace's over n
    with or without the mesh trace; the mesh trace fills the collective
    fields and the roofline's collective term."""
    from repro_torch.launch.dryrun import trace_mesh

    cell = trace_cell(make_cell("tinyllama_1_1b", ShapeSpec(kind, 64, 4, kind), smoke=True))
    before = plan(cell, fake)
    assert before["hlo"]["collective_bytes"] is None
    trace_mesh(cell, fake)
    after = plan(cell, fake)
    for key in ("cost", "memory", "model_flops_per_dev"):
        assert after[key] == before[key], key
    for key in ("dot_flops", "dot_bytes", "while_loops", "max_trip"):
        assert after["hlo"][key] == before["hlo"][key], key
    assert after["hlo"]["dot_flops"] == cell.cost.dot_flops / 4
    h = after["hlo"]
    assert h["collective_count"] > 0 and h["collective_bytes"] == sum(h["collectives"].values())
    assert set(h["collectives"]) == {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                                     "collective-permute"}
    roof = after["roofline"]
    assert roof["collective_s"] == h["collective_bytes"] / 450e9
    assert roof["bound_s"] == max(roof["compute_s"], roof["memory_s"], roof["collective_s"])
    assert after["mesh_trace_s"] is not None and before["mesh_trace_s"] is None


_REFERENCE_COLLECTIVES = r"""
import json, sys
import repro.launch.dryrun as d  # sets XLA_FLAGS (host devices) before JAX starts
import jax
from repro.configs import ShapeSpec, get_config
from repro.launch.mesh import _axis_type_kwargs

arch, kind, profile, S, B, rows, cols, capacity = sys.argv[1:]
if capacity == "1":  # the MoE's capacity dispatch in place of the smoke config's dropless one
    from dataclasses import replace
    d.get_config = lambda a: (lambda c: replace(c, moe=replace(c.moe, dropless=False)))(
        get_config(a, smoke=True))
else:
    d.get_config = lambda a: get_config(a, smoke=True)
d.SHAPES = {"cell": ShapeSpec("cell", int(S), int(B), kind)}
shape = (int(rows), int(cols))
d.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
    shape, ("data", "model"), devices=jax.devices()[:shape[0] * shape[1]],
    **_axis_type_kwargs(2))
lowered, _, _ = d.lower_cell(arch, "cell", False, profile=profile)
h = d.analyze_hlo(lowered.compile().as_text())
print(json.dumps({"collectives": h.collectives, "count": h.collective_count}))
"""


@pytest.mark.parametrize("fake", [(2, 2)], indirect=True)
@pytest.mark.parametrize("kind,profile", [("train", "fsdp"), ("decode", "tp")])
def test_collectives_beside_reference(fake, kind, profile):
    """Smoke TinyLlama on (2,2): the port's collectives by kind beside the
    reference's, summed from its compiled per-device HLO (``pytest -s``
    prints both: PERF.md's table).  The two partitioners differ (DTensor's
    per-op rules against GSPMD's), so the bytes are read, not held equal;
    both issue collectives, under the same five kinds."""
    _beside_reference(fake, "tinyllama-1.1b", kind, profile)


@pytest.mark.parametrize("fake", [(2, 2)], indirect=True)
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v2-236b"])
def test_capacity_moe_collectives_beside_reference(fake, arch, monkeypatch):
    """The smoke MoEs with the capacity dispatch (their full configs'),
    trained under tp on (2,2), so that the experts split over "model":
    the port's collectives beside the reference's (``pytest -s``)."""
    from dataclasses import replace

    import repro_torch.launch.dryrun as dry

    monkeypatch.setattr(dry, "get_config", lambda a, smoke: (lambda c: replace(
        c, moe=replace(c.moe, dropless=False)))(get_config(a, smoke=smoke)))
    _beside_reference(fake, arch, "train", "tp", capacity=True)


def _beside_reference(fake, arch, kind, profile, capacity=False):
    from repro_torch.analysis.cost import COLLECTIVE_KINDS
    from repro_torch.launch.dryrun import trace_mesh

    S, B = 64, 8
    cell = trace_cell(make_cell(arch, ShapeSpec(kind, S, B, kind), smoke=True,
                                profile=profile))
    trace_mesh(cell, fake)
    port, count, _ = cell.collectives["2x2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _REFERENCE_COLLECTIVES, arch, kind,
                          profile, str(S), str(B), "2", "2", str(int(capacity))], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    what = f"{arch} smoke{' capacity' if capacity else ''} {kind} {profile} 2x2"
    for k in COLLECTIVE_KINDS:
        print(f"[collectives] {what} {k}: port {port[k]:.0f} B, "
              f"reference {ref['collectives'][k]:.0f} B")
    print(f"[collectives] {what} total: port {sum(port.values()):.0f}"
          f" B in {count}, reference {sum(ref['collectives'].values()):.0f} B in {ref['count']}")
    assert set(ref["collectives"]) == set(COLLECTIVE_KINDS)
    assert count > 0 and ref["count"] > 0
