"""The port's checkpoint manager, data pipeline and I/O engine against the
JAX package's.

* the files: a tree saved by either package gives the same manifest (but
  the wall time) and the same shard bytes, full and delta;
* restores across the packages: bf16 leaves bit for bit, both ways, and
  delta chains whose members alternate between the packages; a tied-head
  (gemma-2b smoke) train state both ways; a granite-moe smoke train state
  (fp32 router beside bf16 experts) both ways; a whisper-smoke train
  state (lists of layers, not stacked) both ways;
* the write-behind snapshot is a copy: the state is written into in place,
  as the port's AdamW does, before the background writer reads a byte;
* the port saves and restores bf16 without ``ml_dtypes``;
* the data: synthetic shards byte-identical, loader batches equal;
* the engine: one speculated graph of ``core/patterns.py`` through both
  packages' ``Foreactor`` on a ``SimulatedDevice``, same results and the
  same device syscalls, for the ``sync`` and ``io_uring`` backends.
"""

import json
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.core import DeviceProfile as JProfile
from repro.core import Foreactor as JForeactor
from repro.core import MemDevice as JMem
from repro.core import OSDevice as JOS
from repro.core import SimulatedDevice as JSim
from repro.core import io as jio
from repro.data import DataConfig as JDataConfig
from repro.data import ShardedTokenDataset as JDataset
from repro.data import TokenBatchLoader as JLoader
from repro.core.patterns import register_patterns as jregister_patterns
from repro.data import write_synthetic_dataset as jwrite_synthetic
from repro.store.recordio import write_shard as jwrite_shard
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointError, CheckpointManager
from repro_torch.core import DeviceProfile, Foreactor, MemDevice, OSDevice, SimulatedDevice, io
from repro_torch.core.patterns import register_patterns
from repro_torch.data import DataConfig, ShardedTokenDataset, TokenBatchLoader, write_synthetic_dataset
from repro_torch.store.recordio import write_shard
from repro_torch.tree import tree_leaves, tree_map

# the test workers share the machine's cores: two intra-op threads each keep
# torch from starving the others (tests/test_system.py times wall clocks)
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
# small chunks, so that every leaf spans several extents over three shards
MGR = dict(num_shards=3, chunk_bytes=64)


def _np_state(seed):
    """A train-state-shaped tree of numpy arrays: bf16 params, fp32 moments
    and master, a 0-d int32 step, an empty leaf."""
    rng = np.random.default_rng(seed)
    bf16 = lambda *s: rng.standard_normal(s).astype(jnp.bfloat16)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    params = {"embed": bf16(10, 6), "layers": [{"wq": bf16(2, 6, 6), "norm": f32(2, 6)}],
              "lm_head": bf16(6, 10)}
    like = lambda: {"embed": f32(10, 6), "layers": [{"wq": f32(2, 6, 6), "norm": f32(2, 6)}],
                    "lm_head": f32(6, 10)}
    return {"params": params,
            "opt": {"m": like(), "v": like(), "master": like(),
                    "step": np.array(seed, np.int32), "none": np.zeros((0, 3), np.float32)}}


def _torch(tree):
    return bridge.params_from_numpy(tree, "cpu")


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _bits(x):
    """Bit patterns of a leaf of either package, as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16).view(np.int16) if x.dtype.name == "bfloat16" else x


def _assert_same_bits(got, want):
    assert bridge.leaf_names(got) == bridge.leaf_names(want)
    for name, a, b in zip(bridge.leaf_names(got), jax.tree.leaves(got), jax.tree.leaves(want)):
        a, b = _bits(a), _bits(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def _manifest_sans_time(path):
    m = json.loads(path.read_text())
    m.pop("wall_time")
    return m


def _edit(tree, seed):
    """The tree with one leaf's first half and another's last element
    changed: a delta save writes a few extents."""
    out = jax.tree.map(np.array, tree)
    out["opt"]["master"]["embed"][:5] += 1.0
    out["params"]["lm_head"].reshape(-1)[-1] = seed
    out["opt"]["step"] = np.array(seed, np.int32)
    return out


def test_files_match_the_reference_byte_for_byte(tmp_path):
    state = _np_state(1)
    later = _edit(state, 2)
    jm = JManager(JOS(), str(tmp_path / "j"), **MGR)
    tm = CheckpointManager(OSDevice(), str(tmp_path / "t"), **MGR)
    jm.save(4, _jax(state), extra={"step": 4})
    tm.save(4, _torch(state), extra={"step": 4})
    jm.save(5, _jax(later), extra={"step": 5}, delta=True)
    tm.save(5, _torch(later), extra={"step": 5}, delta=True)
    for step in (4, 5):
        d = f"step_{step:010d}"
        jman = _manifest_sans_time(tmp_path / "j" / d / "manifest.json")
        assert _manifest_sans_time(tmp_path / "t" / d / "manifest.json") == jman
        assert {lf["dtype"] for lf in jman["leaves"]} == {"bfloat16", "float32", "int32"}
    assert jman["kind"] == "delta" and jman["base"] == 4
    jf, tf = _files(tmp_path / "j"), _files(tmp_path / "t")
    assert set(jf) == set(tf)
    for name in jf:
        if not name.endswith("manifest.json"):
            assert tf[name] == jf[name], name
    jm.fa.shutdown()
    tm.fa.shutdown()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_bf16_state_restores_bit_identically_across_packages(tmp_path, writer):
    state = _np_state(3)
    jm = JManager(JOS(), str(tmp_path), **MGR)
    tm = CheckpointManager(OSDevice(), str(tmp_path), **MGR)
    if writer == "jax":
        jm.save(7, _jax(state), extra={"by": "jax"})
        step, got, extra = tm.restore_latest(like=_torch(_np_state(0)))
        assert got["params"]["embed"].dtype == torch.bfloat16
    else:
        tm.save(7, _torch(state), extra={"by": "torch"})
        step, got, extra = jm.restore_latest(like=_jax(_np_state(0)))
        assert got["params"]["embed"].dtype == jnp.bfloat16
    assert step == 7 and extra == {"by": writer}
    _assert_same_bits(got, state)
    jm.fa.shutdown()
    tm.fa.shutdown()


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_delta_chain_alternates_between_packages(tmp_path, first):
    """Full save by one package, a delta by the other on top of it, a
    second delta by the first: each package restores every step of the
    chain."""
    jm = JManager(JOS(), str(tmp_path), **MGR)
    tm = CheckpointManager(OSDevice(), str(tmp_path), **MGR)
    trees = {1: _np_state(1)}
    trees[2] = _edit(trees[1], 2)
    trees[3] = _edit(trees[2], 3)
    order = [first, "torch" if first == "jax" else "jax", first]
    for step, pkg in zip((1, 2, 3), order):
        if pkg == "jax":
            jm.save(step, _jax(trees[step]), delta=step > 1)
        else:
            tm.save(step, _torch(trees[step]), delta=step > 1)
    kinds = [(jm.read_manifest(s)["kind"], jm.read_manifest(s)["base"]) for s in (1, 2, 3)]
    assert kinds == [("full", None), ("delta", 1), ("delta", 2)]
    for step in (1, 2, 3):
        jtree, _ = jm.restore_tree(step, _jax(_np_state(0)))
        ttree, _ = tm.restore_tree(step, _torch(_np_state(0)))
        _assert_same_bits(jtree, trees[step])
        _assert_same_bits(ttree, trees[step])
    jm.fa.shutdown()
    tm.fa.shutdown()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_tied_train_state_restores_across_packages(tmp_path, writer):
    """A gemma-2b smoke train state in bf16 (tied head: no ``lm_head``
    leaf; unit-offset norms), saved by one package and restored by the
    other, bit for bit, its leaf names the same on both sides."""
    from dataclasses import replace

    from repro.configs import get_config as jget_config
    from repro.models import build_model as jbuild_model
    from repro.optim.adamw import AdamWConfig as JAdamWConfig
    from repro.optim.adamw import adamw_init as jadamw_init
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_state
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig

    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jparams = jbuild_model(replace(jget_config("gemma-2b", smoke=True), **bf16)).init(
        jax.random.PRNGKey(1))
    jstate = {"params": jparams, "opt": jadamw_init(JAdamWConfig(), jparams)}
    tstate = make_train_state(build_model(replace(get_config("gemma-2b", smoke=True), **bf16)),
                              AdamWConfig(), torch.Generator().manual_seed(2))
    names = bridge.leaf_names(tstate)
    assert names == [jax.tree_util.keystr(p)
                     for p, _ in jax.tree_util.tree_leaves_with_path(jstate)]
    assert "['params']['lm_head']" not in names and "['params']['embed']['tok']" in names
    jm = JManager(JOS(), str(tmp_path), **MGR)
    tm = CheckpointManager(OSDevice(), str(tmp_path), **MGR)
    if writer == "jax":
        jm.save(3, jstate)
        want = jax.tree.map(np.asarray, jstate)
        step, got, _ = tm.restore_latest(like=tstate)
        assert got["params"]["embed"]["tok"].dtype == torch.bfloat16
    else:
        tm.save(3, tstate)
        want = bridge.params_to_numpy(tstate)
        step, got, _ = jm.restore_latest(like=jstate)
        assert got["params"]["embed"]["tok"].dtype == jnp.bfloat16
    assert step == 3
    _assert_same_bits(got, want)
    jm.fa.shutdown()
    tm.fa.shutdown()


def _restore_across_packages(tmp_path, writer, arch, step, mgr=MGR):
    """A smoke train state of ``arch`` with bf16 params, saved at ``step``
    by one package and restored by the other (both managers built with
    ``mgr``), bit for bit, its leaf names the same on both sides; (the
    port's state, the restored state)."""
    from dataclasses import replace

    from repro.configs import get_config as jget_config
    from repro.models import build_model as jbuild_model
    from repro.optim.adamw import AdamWConfig as JAdamWConfig
    from repro.optim.adamw import adamw_init as jadamw_init
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_state
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig

    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jparams = jbuild_model(replace(jget_config(arch, smoke=True), **bf16)).init(
        jax.random.PRNGKey(1))
    jstate = {"params": jparams, "opt": jadamw_init(JAdamWConfig(), jparams)}
    tstate = make_train_state(build_model(replace(get_config(arch, smoke=True), **bf16)),
                              AdamWConfig(), torch.Generator().manual_seed(2))
    assert bridge.leaf_names(tstate) == [
        jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(jstate)]
    jm = JManager(JOS(), str(tmp_path), **mgr)
    tm = CheckpointManager(OSDevice(), str(tmp_path), **mgr)
    if writer == "jax":
        jm.save(step, jstate)
        want = jax.tree.map(np.asarray, jstate)
        got_step, got, _ = tm.restore_latest(like=tstate)
    else:
        tm.save(step, tstate)
        want = bridge.params_to_numpy(tstate)
        got_step, got, _ = jm.restore_latest(like=jstate)
    assert got_step == step
    _assert_same_bits(got, want)
    jm.fa.shutdown()
    tm.fa.shutdown()
    return tstate, got


def _dtypes(*leaves):
    """The dtype names of restored leaves, whichever package restored them."""
    return [str(t.dtype).split(".")[-1] for t in leaves]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_moe_train_state_restores_across_packages(tmp_path, writer):
    """A granite-moe smoke train state with bf16 params, whose router stays
    fp32 beside the bf16 experts, saved by one package and restored by the
    other, bit for bit, its leaf names and dtypes the same on both sides."""
    tstate, got = _restore_across_packages(tmp_path, writer, "granite-moe-3b-a800m", 5)
    ffn = tstate["params"]["layers"][0]["ffn"]
    assert ffn["router"].dtype == torch.float32 and ffn["wi"].dtype == torch.bfloat16
    ffn = got["params"]["layers"][0]["ffn"]
    assert _dtypes(ffn["router"], ffn["wo"]) == ["float32", "bfloat16"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_mla_train_state_restores_across_packages(tmp_path, writer):
    """A deepseek-v2 smoke train state with bf16 params (MLA projections and
    norms in both layers, a dense first layer, then routed experts with an
    fp32 router and a shared expert), saved by one package and restored by
    the other, bit for bit, its leaf names and dtypes the same on both
    sides."""
    tstate, got = _restore_across_packages(tmp_path, writer, "deepseek-v2-236b", 7)
    mla = tstate["params"]["layers"][1]["attn"]
    assert sorted(mla) == ["k_up", "kv_down", "kv_norm", "q_down", "q_norm", "q_up", "v_up",
                           "wo"]
    for layers in (tstate["params"]["layers"], got["params"]["layers"]):
        assert _dtypes(layers[0]["attn"]["q_up"], layers[0]["ffn"]["wi"],
                       layers[1]["attn"]["kv_norm"]["scale"], layers[1]["ffn"]["router"],
                       layers[1]["ffn"]["shared"]["wo"]) == \
            ["bfloat16", "bfloat16", "bfloat16", "float32", "bfloat16"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_whisper_train_state_restores_across_packages(tmp_path, writer):
    """A whisper-smoke train state with bf16 params, whose layers are lists
    of per-layer dicts (not stacked), saved by one package and restored by
    the other, bit for bit, its leaf names and dtypes the same on both
    sides.  The learned decoder positions are 32776 rows whatever the
    config (4 MiB of bf16, 8 MiB a moment in fp32), so the extents here are
    64 KiB, not 64 bytes: still many a leaf, over three shards."""
    tstate, got = _restore_across_packages(tmp_path, writer, "whisper-tiny", 9,
                                           dict(MGR, chunk_bytes=1 << 16))
    for state in (tstate, got):
        params = state["params"]
        assert isinstance(params["enc_layers"], list) and len(params["enc_layers"]) == 2
        assert isinstance(params["dec_layers"], list) and len(params["dec_layers"]) == 2
        assert tuple(params["pos_dec"].shape) == (32776, 64)
        assert _dtypes(params["dec_layers"][1]["xattn"]["wk"], params["enc_norm"]["bias"],
                       state["opt"]["master"]["dec_layers"][0]["mlp"]["wg"]) == \
            ["bfloat16", "bfloat16", "float32"]


class _GatedMem(MemDevice):
    """A MemDevice whose opens wait for ``gate``: the background writer
    cannot read a byte of its snapshot before the test lets it."""

    def __init__(self):
        super().__init__()
        self.gate = threading.Event()

    def open(self, path, flags="r"):
        if flags != "r":
            assert self.gate.wait(30), "the gate was never opened"
        return super().open(path, flags)


def test_write_behind_snapshot_is_a_copy():
    """``save_async``, then the state written into in place (as AdamW
    writes the next step into the state's buffers), then ``wait_pending``:
    the checkpoint holds the values of the call.  On the CPU, ``.cpu()``
    and ``.numpy()`` share memory, so a snapshot of views would write the
    changed values."""
    dev = _GatedMem()
    mgr = CheckpointManager(dev, "/ck", **MGR)
    state = _torch(_np_state(5))
    before = tree_map(lambda t: t.clone(), state)
    mgr.save_async(1, state, extra={"step": 1})
    assert mgr.save_in_flight()
    for t in tree_leaves(state):
        t.copy_(t * 2 + 1)
    dev.gate.set()
    mgr.wait_pending()
    assert not mgr.save_in_flight()
    _, got, _ = mgr.restore_latest(like=state)
    _assert_same_bits(got, before)
    assert [r["mode"] for r in mgr.save_log] == ["async"]
    mgr.fa.shutdown()


def test_restore_checks_the_like_tree():
    mgr = CheckpointManager(MemDevice(), "/ck", **MGR)
    state = _torch(_np_state(2))
    mgr.save(1, state)
    wrong = _torch(_np_state(2))
    wrong["params"]["embed"] = wrong["params"]["embed"].float()
    with pytest.raises(CheckpointError, match="dtype mismatch"):
        mgr.restore_tree(1, wrong)
    wrong["params"]["embed"] = torch.zeros(3, 3, dtype=torch.bfloat16)
    with pytest.raises(CheckpointError, match="shape mismatch"):
        mgr.restore_tree(1, wrong)
    flat, _ = mgr.restore(1)
    assert flat["['opt']['step']"].shape == () and int(flat["['opt']['step']"]) == 2
    mgr.fa.shutdown()


def test_bf16_save_and_restore_without_ml_dtypes():
    code = """
import sys
sys.modules["ml_dtypes"] = None  # any import of it now fails
import torch
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import MemDevice
g = torch.Generator().manual_seed(0)
tree = {"w": torch.randn(33, 7, generator=g).to(torch.bfloat16),
        "m": torch.randn(5, generator=g), "step": torch.tensor(3, dtype=torch.int32)}
mgr = CheckpointManager(MemDevice(), "/ck", num_shards=2, chunk_bytes=64)
mgr.save_async(1, tree)
mgr.wait_pending()
step, got, _ = mgr.restore_latest(like=tree)
assert step == 1 and got["w"].dtype == torch.bfloat16
assert torch.equal(got["w"].view(torch.int16), tree["w"].view(torch.int16))
assert torch.equal(got["m"], tree["m"]) and int(got["step"]) == 3
assert mgr.read_manifest(1)["leaves"][2]["dtype"] == "bfloat16"
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro", "ml_dtypes")
             and sys.modules[m] is not None)
assert not bad, bad
mgr.fa.shutdown()
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stdout + res.stderr


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def _datasets(prefetch):
    dcfg = dict(seq_len=16, batch_size=3, seed=9)
    jdev, tdev = JMem(), MemDevice()
    jpaths = jwrite_synthetic(jdev, "/data", JDataConfig(**dcfg), 3, 7, vocab_size=1000)
    tpaths = write_synthetic_dataset(tdev, "/data", DataConfig(**dcfg), 3, 7, vocab_size=1000)
    assert tpaths == jpaths
    jl = JLoader(JDataset(jdev, jpaths), JDataConfig(**dcfg), prefetch=prefetch)
    tl = TokenBatchLoader(ShardedTokenDataset(tdev, tpaths), DataConfig(**dcfg),
                          prefetch=prefetch)
    return jdev, tdev, jpaths, jl, tl


def test_synthetic_shards_are_byte_identical():
    jdev, tdev, paths, jl, tl = _datasets(prefetch=False)
    for p in paths:
        assert bytes(tdev._files[p]) == bytes(jdev._files[p]), p


@pytest.mark.parametrize("prefetch", [True, False])
def test_loader_batches_equal_the_reference(prefetch):
    _, _, _, jl, tl = _datasets(prefetch)
    assert tl.steps_per_epoch == jl.steps_per_epoch == 7
    for e, s in [(0, 0), (0, 1), (0, 6), (1, 0), (1, 1), (3, 4)]:
        got, want = tl.load(e, s), jl.load(e, s)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == np.int32 and got[k].shape == (3, 16)
            np.testing.assert_array_equal(got[k], want[k])
    jl.close()
    tl.close()


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
def _logging(sim_cls, mem_cls, log):
    """``sim_cls`` over a ``mem_cls`` that logs each syscall it serves."""
    class Logged(mem_cls):
        pass

    for op in ("open", "pread", "pwrite", "fsync", "close", "rename", "unlink", "fstatat"):
        def make(op):
            base = getattr(mem_cls, op)

            def f(self, *args):
                # data by its length; staged names without their per-process
                # transaction counter
                shown = tuple(len(a) if isinstance(a, (bytes, bytearray, memoryview))
                              else re.sub(r"__stg\.[^/]*", "__stg", a) if isinstance(a, str)
                              else a for a in args)
                log.append((op,) + shown)
                return base(self, *args)
            return f
        setattr(Logged, op, make(op))
    return sim_cls(inner=Logged(), profile=(JProfile if sim_cls is JSim else DeviceProfile)(
        channels=8, base_latency=2e-4, per_byte=0.0, crossing_cost=0.0,
        metadata_latency=1e-4))


def _engine_run(pkg, backend):
    """Write one record shard through the ``write_file`` graph (a staged,
    undoable create; pre-issued writes; fsync and close as harvest
    barriers), then read its records back through ``pread_extents``."""
    log = []
    if pkg == "jax":
        dev = _logging(JSim, JMem, log)
        fa, wshard, iomod = JForeactor(device=dev, backend=backend, depth=8), jwrite_shard, jio
        jregister_patterns(fa)
    else:
        dev = _logging(SimulatedDevice, MemDevice, log)
        fa, wshard, iomod = Foreactor(device=dev, backend=backend, depth=8), write_shard, io
        register_patterns(fa)
    records = [bytes([i]) * 24 for i in range(12)]
    wshard(dev, "/d/shard.rio", records, fa=fa)
    fd = iomod.open(dev, "/d/shard.rio", "r")
    extents = [(fd, 24, 16 + 24 * i) for i in (3, 0, 11, 5, 5, 7)]

    @fa.wrap("pread_extents", lambda extents: {"extents": extents})
    def read_all(extents):
        return [iomod.pread(dev, f, n, off) for f, n, off in extents]

    out = read_all(extents)
    iomod.close(dev, fd)
    fa.shutdown()
    return out, bytes(dev.inner._files["/d/shard.rio"]), log


@pytest.mark.parametrize("backend", ["sync", "io_uring"])
def test_engine_runs_a_speculated_graph_as_the_reference(backend):
    jout, jfile, jlog = _engine_run("jax", backend)
    tout, tfile, tlog = _engine_run("torch", backend)
    assert tout == jout == [bytes([i]) * 24 for i in (3, 0, 11, 5, 5, 7)]
    assert tfile == jfile
    # workers serve pre-issued requests in any order; the sync backend's
    # order is the program's
    if backend == "sync":
        assert tlog == jlog
    else:
        assert sorted(map(repr, tlog)) == sorted(map(repr, jlog))
    assert any(op == "rename" for op, *_ in tlog)  # the staged create published


def test_mine_is_not_ported():
    fa = Foreactor(device=MemDevice())

    def f(dev):
        fd = io.open(dev, "/x", "w")
        io.close(dev, fd)

    wrapped = fa.wrap("auto_f", lambda dev: {}, auto_graph=True, observe_calls=1)(f)
    wrapped(fa.device)
    assert wrapped.__foreactor_auto__["state"] == "disabled"
    assert "ROADMAP A9" in wrapped.__foreactor_auto__["reason"]
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        fa.mine("auto_f")
    fa.shutdown()
