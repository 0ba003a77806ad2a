"""The port over a ``DeviceMesh`` of gloo ranks on the CPU, against the
port in one process and the JAX reference.

Each mesh shape's process group is spawned once (``tests/_torch_mesh_worker.py``
on (2,1) and (1,2), two ranks each, side by side; then (2,2), four ranks),
with a timeout each and a ``FileStore`` (no ports); the ranks run every
case and write the results, which the parametrised cases read:

* loss and every gradient leaf of the fp32 smoke configs of tinyllama
  (GQA), granite (MoE: dropless dispatch on local token shards, the
  experts' hidden dim split over "model" under tp; and the capacity
  dispatch, the experts over "model", or with 3 experts their hidden
  dim), deepseek-v2 (MLA), zamba2 and rwkv6, under both profiles (and
  remat ``nothing`` / ``dots``, and ``nothing`` with the backward on
  another thread, where the recompute must still see the mesh and the
  profile), equal to one process at 1e-5; the one-process loss and
  gradients equal JAX's at 1e-4;
* greedy tokens (prefill + decode, the cache's rows over the data axes)
  identical to one process;
* three ``make_train_step`` steps: every state leaf at 1e-5;
* checkpoints: the train state saved from the ranks is the meshless save
  byte for byte (manifest but its wall time, every shard file), and
  restores in the reference package; ``Trainer.fit`` resumes across
  meshes, 2 -> 1, 1 -> 4 and 2 -> 4, each equal to one continuous meshless
  run at 1e-5;
* ``torchrun --nproc-per-node 2`` runs the serve and train launchers on
  the CPU.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import get_config as jget_config
from repro.core import OSDevice as JOS
from repro.models import build_model as jbuild_model
from repro_torch import bridge
from repro_torch.core import OSDevice
from repro_torch.data import DataConfig, write_synthetic_dataset
from repro_torch.launch.steps import make_generate_loop, make_train_state, make_train_step
from repro_torch.optim import AdamWConfig
from repro_torch.tree import tree_leaves

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_mesh_worker as W  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
JAX_TOL = 1e-4
SPAWN_TIMEOUT = 300
MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}
PROFILES = ("tp", "fsdp")
GRADS = [(a, p, "off") for a in W.ARCHS for p in PROFILES] + [
    ("tinyllama-1.1b", "tp", "nothing"), ("granite-moe-3b-a800m", "tp", "dots"),
    ("tinyllama-1.1b", "fsdp", "thread"), ("granite-moe-3b-a800m", "fsdp", "thread")] + [
    ("granite-moe-3b-a800m", p, "capacity") for p in PROFILES] + [
    ("granite-moe-3b-a800m", "tp", "capacity3")]
GENERATE = [(a, p) for a in W.ARCHS for p in PROFILES]
# what each mesh runs beyond the gradients: on the two-rank meshes the greedy
# tokens under tp and the train steps of TinyLlama alone (Trainer.fit runs
# more of them), on (2,2) every arch; (profile of the steps, archs)
GENERATE_ON = {"2x1": [g for g in GENERATE if g[1] == "tp"],
               "1x2": [g for g in GENERATE if g[1] == "tp"], "2x2": GENERATE}
STEPS = {"2x1": ("fsdp", W.ARCHS[:1]), "1x2": ("tp", W.ARCHS[:1]), "2x2": ("tp", W.ARCHS)}


def _spawn(tmp: Path, name: str, job: dict):
    """Start the ranks of one mesh; returns the processes and the job."""
    shape = MESHES[name]
    world = shape[0] * shape[1]
    out = tmp / name
    out.mkdir()
    job = dict(job, shape=list(shape), out=str(out))
    (out / "job.json").write_text(json.dumps(job))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_mesh_worker.py"),
                               str(r), str(world), str(out / "store"), str(out / "job.json")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    return procs, out


def _join(procs):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]


def _meshless_fit(root, data, steps, ckpt_every):
    return W.fit_trainer(str(root), str(data), steps, ckpt_every, "cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's results, and the meshless runs the checkpoint crossings
    start from or are held against."""
    tmp = tmp_path_factory.mktemp("mesh")
    data = tmp / "data"
    cfg = W.config("tinyllama-1.1b")
    write_synthetic_dataset(OSDevice(), str(data), DataConfig(**W.DATA), 2, 24,
                            vocab_size=cfg.vocab_size)
    _meshless_fit(tmp / "ck_1", data, 4, 2)          # 1 -> 4 starts here
    continuous = _meshless_fit(tmp / "ck_cont", data, 6, 0)
    base = dict(data=str(data), grads=GRADS)

    def steps(name):
        return dict(generate=GENERATE_ON[name], steps=[[a, STEPS[name][0]] for a in STEPS[name][1]])

    first = [_spawn(tmp, name, dict(base, **steps(name),
                                    ckpt=str(tmp / f"ckpt_{name}"),
                                    fit=[{"name": "0to4", "root": str(tmp / "ck_2"),
                                          "steps": 4, "ckpt_every": 2, "profile": "fsdp"}]
                                    if name == "2x1" else []))
             for name in ("2x1", "1x2")]
    for procs, _ in first:
        _join(procs)
    shutil.copytree(tmp / "ck_2", tmp / "ck_2to4")
    shutil.copytree(tmp / "ck_2", tmp / "ck_2to1")
    procs, _ = _spawn(tmp, "2x2", dict(base, **steps("2x2"),
                                       ckpt=str(tmp / "ckpt_2x2"),
                                       fit=[{"name": "2to4", "root": str(tmp / "ck_2to4"),
                                             "steps": 6, "ckpt_every": 0, "profile": "tp"},
                                            {"name": "1to4", "root": str(tmp / "ck_1"),
                                             "steps": 6, "ckpt_every": 0, "profile": "fsdp"}]))
    _join(procs)
    two_to_one = _meshless_fit(tmp / "ck_2to1", data, 6, 0)
    return {"tmp": tmp, "continuous": continuous, "2to1": two_to_one}


def _load(runs, mesh, name):
    with np.load(runs["tmp"] / mesh / f"{name}.npz") as z:
        return [z[str(i)] for i in range(len(z.files))]


def _close(got, want, tol, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32),
                                   atol=tol, rtol=tol, err_msg=f"{what} leaf {i}")


_ONE = {}


def _one_process_grads(arch, variant):
    if (arch, variant) not in _ONE:
        cfg = W.config(arch, variant)
        model, params = W.params_of(cfg)
        loss, grads = W.loss_and_grads(model, params, W.batch_of(cfg))
        _ONE[arch, variant] = [loss.detach().numpy()] + [g.numpy() for g in grads]
    return _ONE[arch, variant]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,profile,variant", GRADS)
def test_loss_and_grads_equal_one_process(runs, mesh, arch, profile, variant):
    _close(_load(runs, mesh, f"grads_{arch}_{profile}_{variant}"),
           _one_process_grads(arch, variant), TOL, f"{arch} {profile} {variant} on {mesh}")


@pytest.mark.parametrize("arch", W.ARCHS)
def test_one_process_equals_jax(arch):
    """The reference's loss and gradients on the same weights and batch."""
    cfg = W.config(arch)
    _, params = W.params_of(cfg)
    batch = {k: jnp.asarray(v.numpy()) for k, v in W.batch_of(cfg).items()}
    jmodel = jbuild_model(jget_config(arch, smoke=True))
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jax.tree.map(jnp.asarray, bridge.params_to_numpy(params)), batch)
    _close(_one_process_grads(arch, "off"),
           [np.asarray(jloss)] + [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrads)],
           JAX_TOL, f"{arch} vs JAX")


@pytest.mark.parametrize("mesh,arch,profile", [(m, a, p) for m in MESHES
                                               for a, p in GENERATE_ON[m]])
def test_greedy_tokens_identical(runs, mesh, arch, profile):
    cfg = W.config(arch)
    model, params = W.params_of(cfg)
    prompt = {"tokens": W.batch_of(cfg, 2)["tokens"][:, :W.PROMPT]}
    want = make_generate_loop(model, W.GEN)(params, prompt, W.PROMPT + W.GEN + 1)
    np.testing.assert_array_equal(_load(runs, mesh, f"generate_{arch}_{profile}")[0],
                                  want.numpy())


_STEPS = {}


@pytest.mark.parametrize("mesh,arch", [(m, a) for m in MESHES for a in STEPS[m][1]])
def test_three_train_steps_equal_meshless(runs, mesh, arch):
    if arch not in _STEPS:
        cfg = W.config(arch)
        model, _ = W.params_of(cfg)
        opt = AdamWConfig(**W.OPT)
        state = make_train_state(model, opt, torch.Generator().manual_seed(0))
        step, losses = make_train_step(model, opt), []
        for i in range(3):
            state, metrics = step(state, W.batch_of(cfg, 10 + i))
            losses.append(float(metrics["loss"]))
        _STEPS[arch] = [np.array(losses)] + [t.numpy() for t in tree_leaves(state)]
    _close(_load(runs, mesh, f"steps_{arch}_{STEPS[mesh][0]}"), _STEPS[arch], TOL,
           f"{arch} steps on {mesh}")


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(Path(root).rglob("*"))
            if p.is_file()}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_checkpoint_from_ranks_equals_meshless(runs, mesh, tmp_path):
    """The same state saved from the ranks and from one process: every
    file equal, the manifest but its wall time; the reference restores it."""
    from repro_torch.checkpoint import CheckpointManager

    model, _ = W.params_of(W.config("tinyllama-1.1b"))
    state = make_train_state(model, AdamWConfig(**W.FIT_OPT), torch.Generator().manual_seed(0))
    mgr = CheckpointManager(OSDevice(), str(tmp_path), num_shards=2, chunk_bytes=1 << 14)
    mgr.save(1, state, extra={"epoch": 0, "step": 1})
    mgr.close()
    ranks, meshless = _files(runs["tmp"] / f"ckpt_{mesh}"), _files(tmp_path)
    assert sorted(ranks) == sorted(meshless)
    for name in ranks:
        if name.endswith("manifest.json"):
            a, b = json.loads(ranks[name]), json.loads(meshless[name])
            a.pop("wall_time"), b.pop("wall_time")
            assert a == b
        else:
            assert ranks[name] == meshless[name], name
    flat, extra = JManager(JOS(), str(runs["tmp"] / f"ckpt_{mesh}")).restore(1)
    assert extra["step"] == 1
    want = dict(zip(bridge.leaf_names(state), tree_leaves(state)))
    assert sorted(flat) == sorted(want)
    for name, arr in flat.items():
        np.testing.assert_array_equal(np.asarray(arr), want[name].numpy(), err_msg=name)


@pytest.mark.parametrize("crossing", ["2to1", "1to4", "2to4"])
def test_resume_across_meshes(runs, crossing):
    """A checkpoint written on one mesh (or none) resumed on another: the
    final state equals the continuous meshless run's at 1e-5."""
    want = [np.array(runs["continuous"]["losses"][-2:])] + \
        [t.numpy() for t in tree_leaves(runs["continuous"]["state"])]
    if crossing == "2to1":
        out = runs["2to1"]
        got = [np.array(out["losses"])] + [t.numpy() for t in tree_leaves(out["state"])]
    else:
        got = _load(runs, "2x2", f"fit_{crossing}")
    assert len(got[0]) == 2  # resumed at step 4, ran 4 and 5
    _close(got, want, TOL, crossing)


def _torchrun(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", "2", *args], env=env, capture_output=True,
                          text=True, timeout=SPAWN_TIMEOUT)


def test_serve_launcher_under_torchrun():
    res = _torchrun("-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu",
                    "--batch", "4", "--prompt-len", "16", "--gen", "4")
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("[serve]")]
    assert len(lines) == 4, res.stdout  # rank 0 alone prints
    assert "generated (4, 4) tokens" in lines[0]


def test_train_launcher_under_torchrun(tmp_path):
    res = _torchrun("-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
                    "--steps", "4", "--batch", "4", "--seq", "32", "--ckpt-every", "2",
                    "--data", str(tmp_path / "data"), "--ckpt", str(tmp_path / "ck"))
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.count("[train] done: step 4") == 1, res.stdout
    assert sorted(p.name for p in (tmp_path / "ck").iterdir() if p.name.startswith("step_")) \
        == ["step_0000000002", "step_0000000004"]
