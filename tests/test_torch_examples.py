"""The port's twins of the repo-level example drivers against the reference's.

* ``examples/{quickstart,lsm_serving,checkpoint_dr}_torch.py`` against
  ``examples/{quickstart,lsm_serving,checkpoint_dr}.py``: the reference runs
  twice; every line those two runs print alike the twin prints alike, and
  every other line (the timings) has the reference's form, numbers aside.
* ``examples/train_100m_torch.py`` against ``examples/train_100m.py``
  (``--tiny``): the reference trains 8 steps; from copies of its work
  directory the reference and the port each resume to 12, and must agree
  on the four losses and every state leaf; the reference then resumes from
  the port's step-12 checkpoint as from its own.  The full ~100M config's
  parameter count equals the reference's (shapes only: the port's model
  on the ``meta`` device, the reference's through ``jax.eval_shape``); both
  drivers hold the same two configs field for field; without a card and
  without ``--device cpu`` the port's driver refuses to run.
"""

import ast
import contextlib
import io
import os
import re
import runpy
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import build_model as jbuild_model
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import bridge
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves

# the test workers share the machine's cores (tests/test_system.py times wall clocks)
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
HOST_TWINS = ("quickstart", "lsm_serving", "checkpoint_dr")
NUMBER = re.compile(r"[0-9]+(?:\.[0-9]+)?")
LOSS_RTOL = 1e-4
STATE_RTOL, STATE_ATOL = 1e-4, 1e-5   # fp32


def _run(script: Path) -> list:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, str(script)], env=env, capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout.splitlines()


def _form(line: str) -> re.Pattern:
    """``line`` with each number a wildcard and runs of blanks one blank."""
    parts = NUMBER.split(" ".join(line.split()))
    return re.compile("[0-9]+(?:\\.[0-9]+)?".join(re.escape(p) for p in parts) + "$")


@pytest.mark.parametrize("name", HOST_TWINS)
def test_host_twin_prints_the_references_lines(name):
    ref_a, ref_b = _run(EXAMPLES / f"{name}.py"), _run(EXAMPLES / f"{name}.py")
    twin = _run(EXAMPLES / f"{name}_torch.py")
    assert len(ref_a) == len(ref_b) == len(twin), (ref_a, twin)
    for a, b, t in zip(ref_a, ref_b, twin):
        if a == b:
            assert t == a
        else:  # a timing line: its form, numbers aside
            assert _form(a).match(" ".join(t.split())), (a, t)
    if name == "quickstart":
        assert "identical result" in twin[1]


# ---------------------------------------------------------------------------
# train_100m
# ---------------------------------------------------------------------------
def _driver(script: Path, *argv: str):
    """Run a driver in this process; (its globals, what it printed)."""
    buf = io.StringIO()
    old = sys.argv
    sys.argv = [str(script), *argv]
    try:
        with contextlib.redirect_stdout(buf):
            env = runpy.run_path(str(script), run_name="__main__")
    finally:
        sys.argv = old
    return env, buf.getvalue()


def _reference(workdir, steps):
    return _driver(EXAMPLES / "train_100m.py", "--tiny", "--steps", str(steps),
                   "--workdir", str(workdir))


def _port(workdir, steps):
    return _driver(EXAMPLES / "train_100m_torch.py", "--tiny", "--steps", str(steps),
                   "--workdir", str(workdir), "--device", "cpu")


def _numpy_state(out):
    state = out["state"]
    if isinstance(tree_leaves(state)[0], torch.Tensor):
        return dict(zip(bridge.leaf_names(state), (t.numpy() for t in tree_leaves(state))))
    state = jax.tree.map(np.asarray, state)
    return dict(zip(bridge.leaf_names(state), jax.tree.leaves(state)))


def _assert_states_close(got, want):
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=name)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """The reference's 8 tiny steps, then from copies of its work directory
    the reference's and the port's resumes to step 12."""
    tmp = tmp_path_factory.mktemp("train_100m")
    _, log = _reference(tmp / "base", 8)
    assert "over 8 steps" in log, log
    for name in ("ref", "port"):
        shutil.copytree(tmp / "base", tmp / name)
    ref, ref_log = _reference(tmp / "ref", 12)
    port, port_log = _port(tmp / "port", 12)
    return tmp, (ref["out"], ref_log), (port["out"], port_log)


def test_port_resumes_the_references_train_100m_checkpoint(resumed):
    _, (ref, ref_log), (port, port_log) = resumed
    for log in (ref_log, port_log):
        assert "[trainer] restored step 8 -> resuming at (epoch 0, step 8)" in log, log
        assert "over 12 steps" in log, log
    assert len(ref["losses"]) == len(port["losses"]) == 4
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=LOSS_RTOL)
    _assert_states_close(_numpy_state(port), _numpy_state(ref))


def test_reference_resumes_the_ports_train_100m_checkpoint(resumed):
    """The reference takes step 12 from the port's checkpoint as from its own."""
    tmp, _, _ = resumed
    from_port, log = _reference(tmp / "port", 13)
    assert "[trainer] restored step 12 -> resuming at" in log, log
    from_ref, _ = _reference(tmp / "ref", 13)
    np.testing.assert_allclose(from_port["out"]["losses"], from_ref["out"]["losses"],
                               rtol=LOSS_RTOL)
    _assert_states_close(_numpy_state(from_port["out"]), _numpy_state(from_ref["out"]))


def _driver_configs(script: Path):
    """The keywords of each ``ModelConfig(...)`` call of a driver and its
    ``seq, batch = ...`` pairs, in the order of the source."""
    tree = ast.parse(script.read_text())
    cfgs = [{kw.arg: ast.literal_eval(kw.value) for kw in node.keywords}
            for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "ModelConfig"]
    shapes = [ast.literal_eval(node.value) for node in ast.walk(tree)
              if isinstance(node, ast.Assign) and ast.unparse(node.targets[0]) == "seq, batch"]
    return cfgs, shapes


def test_train_100m_configs_and_parameter_count_equal_the_references():
    cfgs, shapes = _driver_configs(EXAMPLES / "train_100m_torch.py")
    assert (cfgs, shapes) == _driver_configs(EXAMPLES / "train_100m.py")
    assert [c["name"] for c in cfgs] == ["llama-tiny", "llama-100m"]
    full = cfgs[1]
    with torch.device("meta"):
        params = build_model(ModelConfig(**full)).init(torch.Generator())
    n_port = sum(t.numel() for t in tree_leaves(params))
    shapes_ref = jax.eval_shape(jbuild_model(JModelConfig(**full)).init, jax.random.PRNGKey(0))
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes_ref))
    assert n_port == n_ref
    assert 90e6 < n_port < 130e6  # "~100M"


@pytest.mark.skipif(torch.cuda.is_available(), reason="the refusal is of a machine without a card")
def test_train_100m_twin_refuses_without_a_card(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _driver(EXAMPLES / "train_100m_torch.py", "--tiny", "--steps", "1",
                "--workdir", str(tmp_path))
    assert not any(tmp_path.iterdir())  # refused before it wrote anything


def test_train_100m_twin_over_the_host_mesh_under_torchrun(tmp_path):
    """Under ``torchrun`` (two gloo ranks) the twin trains over the host
    mesh, rank 0 alone prints, and its checkpoint holds the state of the
    one-process run's at 1e-5."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import OSDevice

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "2", str(EXAMPLES / "train_100m_torch.py"),
                          "--tiny", "--steps", "4", "--device", "cpu",
                          "--workdir", str(tmp_path / "mesh")],
                         env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.count("params: ") == 1 and "over 4 steps" in res.stdout, res.stdout
    _port(tmp_path / "one", 4)
    restored = []
    for name in ("mesh", "one"):
        mgr = CheckpointManager(OSDevice(), str(tmp_path / name / "ckpt"))
        restored.append(mgr.restore_latest())
        mgr.fa.shutdown()
    (step_a, mesh, _), (step_b, one, _) = restored
    assert step_a == step_b == 4 and sorted(mesh) == sorted(one)
    for name in one:
        np.testing.assert_allclose(mesh[name].numpy(), one[name].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
