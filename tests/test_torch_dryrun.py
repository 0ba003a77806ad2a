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
    cfg = get_config(arch)
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
