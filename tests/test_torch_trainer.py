"""The port's training runtime, and its resumes across the two packages.

Twins of tests/test_trainer.py on the port (the smoke TinyLlama in fp32 on
the CPU, a ``MemDevice``): the loss goes down, a checkpoint restart equals
the continuous run, a crash writes an emergency checkpoint.  Then the
cross-package resume: JAX trains 6 steps and saves, the port restores and
trains to 12; the port trains 0 -> 6 from JAX's saved initial state, JAX
restores and trains to 12; each final state against JAX's continuous
12-step run at 1e-5 on every state leaf.
"""

import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import get_config as jget_config
from repro.core import OSDevice as JOS
from repro.data import DataConfig as JDataConfig
from repro.data import ShardedTokenDataset as JDataset
from repro.data import TokenBatchLoader as JLoader
from repro.data import write_synthetic_dataset as jwrite_synthetic
from repro.launch.mesh import make_host_mesh
from repro.models import build_model as jbuild_model
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.runtime import Trainer as JTrainer
from repro.runtime import TrainerConfig as JTrainerConfig
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import MemDevice, OSDevice
from repro_torch.data import DataConfig, ShardedTokenDataset, TokenBatchLoader, write_synthetic_dataset
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.tree import tree_leaves

# the test workers share the machine's cores: two intra-op threads each keep
# torch from starving the others (tests/test_system.py times wall clocks)
torch.set_num_threads(2)

ARCH = "tinyllama_1_1b"
DATA = dict(seq_len=32, batch_size=4, seed=5)
CROSS_TOL = 1e-5
# eps 1e-3 keeps the update continuous at the grads' scale: with 1e-8 the
# update of a weight whose gradient lies within fp32 noise of zero is
# lr * sign(g), which the two packages' noise flips by 2 lr
CROSS_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=12, grad_clip=1.0, eps=1e-3)


def setup(steps=12, ckpt_every=0, root="/ck", dev=None, schedule_steps=None):
    """The port's twin of tests/test_trainer.py's ``setup``."""
    dev = dev or MemDevice()
    cfg = get_config(ARCH, smoke=True)
    dcfg = DataConfig(**DATA)
    write_synthetic_dataset(dev, "/data", dcfg, 2, 24, vocab_size=cfg.vocab_size)
    ds = ShardedTokenDataset(dev, [f"/data/shard_{i:05d}.rio" for i in range(2)])
    loader = TokenBatchLoader(ds, dcfg, prefetch=False)
    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2,
                      total_steps=schedule_steps or steps, grad_clip=1.0)
    ckpt = CheckpointManager(dev, root, num_shards=2, chunk_bytes=1 << 14) \
        if ckpt_every else None
    tcfg = TrainerConfig(steps=steps, ckpt_every=ckpt_every, log_every=0)
    return dev, Trainer(model, opt, loader, ckpt, "cpu", tcfg)


def test_loss_decreases():
    _, tr = setup(steps=15)
    out = tr.fit()
    losses = out["losses"]
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert out["final_step"] == 15
    assert np.isfinite(losses).all()


def test_checkpoint_restart_is_deterministic():
    dev1, tr1 = setup(steps=12, ckpt_every=50, root="/ck1")
    out1 = tr1.fit()
    dev2, tr2 = setup(steps=6, ckpt_every=6, root="/ck2", schedule_steps=12)
    tr2.fit()
    dev2b, tr2b = setup(steps=12, ckpt_every=50, root="/ck2", dev=dev2)
    out2 = tr2b.fit()
    assert tr2b.restore_s > 0 and out2["final_step"] == 12 and len(out2["losses"]) == 6
    for a, b in zip(tree_leaves(out1["state"]), tree_leaves(out2["state"])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=1e-6)


def test_emergency_checkpoint_on_crash():
    dev, tr = setup(steps=50, ckpt_every=100, root="/ck")
    calls = {"n": 0}
    orig_load = tr.loader.load

    def exploding_load(e, s):
        calls["n"] += 1
        if calls["n"] > 5:
            raise RuntimeError("node failure!")
        return orig_load(e, s)

    tr.loader.load = exploding_load
    with pytest.raises(RuntimeError, match="node failure"):
        tr.fit()
    assert tr.ckpt.latest_step() == 5  # emergency save landed
    out = tr.ckpt.restore_latest()
    assert out is not None
    step, flat, extra = out
    assert extra["emergency"] and int(flat["['opt']['step']"]) == 5


def test_write_behind_saves_overlap_and_restore():
    """Write-behind saves every 2 steps, then the final synchronous save,
    which replaces step 6's: each one committed, and a restore of the last
    equals the final state."""
    dev, tr = setup(steps=6, ckpt_every=2, root="/wb")
    out = tr.fit()
    assert tr.ckpt.committed_steps() == [2, 4, 6]
    assert [(r["step"], r["mode"]) for r in tr.ckpt.save_log] == [
        (2, "async"), (4, "async"), (6, "async"), (6, "sync")]
    assert len(tr.events) == 6 and all(isinstance(ev.save_in_flight, bool) for ev in tr.events)
    _, restored, _ = tr.ckpt.restore_latest(like=out["state"])
    for a, b in zip(tree_leaves(restored), tree_leaves(out["state"])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# resume across the packages
# ---------------------------------------------------------------------------
def _jax_trainer(tmp, steps, ckpt_root=None, ckpt_every=0):
    cfg = jget_config(ARCH, smoke=True)
    dev = JOS()
    dcfg = JDataConfig(**DATA)
    paths = [f"{tmp}/data/shard_{i:05d}.rio" for i in range(2)]
    if not os.path.exists(paths[0]):
        jwrite_synthetic(dev, f"{tmp}/data", dcfg, 2, 24, vocab_size=cfg.vocab_size)
    loader = JLoader(JDataset(dev, paths), dcfg, prefetch=False)
    ckpt = JManager(dev, ckpt_root, num_shards=2, chunk_bytes=1 << 14) if ckpt_root else None
    tcfg = JTrainerConfig(steps=steps, ckpt_every=ckpt_every, log_every=0)
    return JTrainer(jbuild_model(cfg), JAdamWConfig(**CROSS_OPT), loader, ckpt,
                    make_host_mesh(), tcfg)


def _torch_trainer(tmp, steps, ckpt_root, ckpt_every=0):
    cfg = get_config(ARCH, smoke=True)
    dev = OSDevice()
    dcfg = DataConfig(**DATA)
    paths = [f"{tmp}/data/shard_{i:05d}.rio" for i in range(2)]
    loader = TokenBatchLoader(ShardedTokenDataset(dev, paths), dcfg, prefetch=False)
    ckpt = CheckpointManager(dev, ckpt_root, num_shards=2, chunk_bytes=1 << 14)
    tcfg = TrainerConfig(steps=steps, ckpt_every=ckpt_every, log_every=0)
    return Trainer(build_model(cfg), AdamWConfig(**CROSS_OPT), loader, ckpt, "cpu", tcfg)


@pytest.fixture(scope="module")
def jax_continuous(tmp_path_factory):
    """JAX's continuous 12-step run, as numpy leaves by name."""
    tmp = tmp_path_factory.mktemp("jax12")
    out = _jax_trainer(tmp, 12).fit()
    state = jax.tree.map(np.asarray, out["state"])
    return tmp, dict(zip(bridge.leaf_names(state), jax.tree.leaves(state)))


def _assert_state_close(got, want):
    names = bridge.leaf_names(got)
    assert names == list(want)
    worst = 0.0
    for name, t in zip(names, tree_leaves(got)):
        a = t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)
        b = np.asarray(want[name], np.float32)
        worst = max(worst, float(np.abs(a - b).max()) if a.size else 0.0)
        np.testing.assert_allclose(a, b, atol=CROSS_TOL, rtol=CROSS_TOL, err_msg=name)
    # `pytest -s` shows this line: the CPU parity reading of PERF.md
    print(f"[parity] {os.environ.get('PYTEST_CURRENT_TEST', '').split(' ')[0]}: "
          f"{len(names)} state leaves, max_abs_err={worst:.3e} tol={CROSS_TOL:g}")


def test_port_resumes_a_jax_checkpoint(jax_continuous, tmp_path):
    data_tmp, want = jax_continuous
    root = str(tmp_path / "ck")
    _jax_trainer(data_tmp, 6, root, ckpt_every=6).fit()
    tr = _torch_trainer(data_tmp, 12, root, ckpt_every=50)
    out = tr.fit()
    assert out["final_step"] == 12 and len(out["losses"]) == 6
    _assert_state_close(out["state"], want)


def test_jax_resumes_a_port_checkpoint(jax_continuous, tmp_path):
    """JAX saves its initial state (a run of 0 steps), the port trains
    0 -> 6 from it and saves, JAX restores and trains to 12."""
    data_tmp, want = jax_continuous
    root = str(tmp_path / "ck")
    _jax_trainer(data_tmp, 0, root).fit()
    out6 = _torch_trainer(data_tmp, 6, root, ckpt_every=6).fit()
    assert out6["final_step"] == 6 and len(out6["losses"]) == 6
    out = _jax_trainer(data_tmp, 12, root, ckpt_every=50).fit()
    assert out["final_step"] == 12 and len(out["losses"]) == 6
    _assert_state_close(jax.tree.map(np.asarray, out["state"]), want)
