"""The port's spans and counters (``repro_torch.spans``) on the CPU.

A tiny MoE trainer (the granite smoke config with capacity dispatch, the
``dots`` remat policy and the attention through its autograd Function, so
that the backward opens ``plain backward`` ranges and remat recomputes)
runs ``Trainer.fit``; its spans nest under each ``train: step`` in the
program's order, the backward's children (and a span the test opens in
each remat recompute) take it as their parent, and the checkpoint timers
and ``phase_ms`` come from the spans.  Then the ring's bound, the
profiler's ranges (and none without a profiler; a range open across one
session's stop and the next one's start), the MoE drop
counter against ``_slots``' kept mask, counted once a step and only while a
profiler records, the serve loop's spans, and, on the card, device spans
that never synchronise.
"""

import dataclasses
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import MemDevice
from repro_torch.data import DataConfig, ShardedTokenDataset, TokenBatchLoader, write_synthetic_dataset
from repro_torch.launch.steps import make_generate_loop, make_train_state, make_train_step
from repro_torch.models import build_model, mlp
from repro_torch.models.common import recomputing
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import Trainer, TrainerConfig

# the test workers share the machine's cores: two intra-op threads each keep
# torch from starving the others (tests/test_system.py times wall clocks)
torch.set_num_threads(2)

DATA = dict(seq_len=32, batch_size=4, seed=5)
PHASES = ["data: load", "train: to_device", "train: forward", "train: backward",
          "train: optimizer", "train: sync"]


def moe_config():
    """Granite's smoke widths with capacity dispatch at 1.0 over 32-token
    groups (so that some assignments drop), remat under ``dots`` and the
    attention through ``ops``' autograd Function."""
    cfg = get_config("granite-moe-3b-a800m", smoke=True)
    return dataclasses.replace(
        cfg, remat=True, remat_policy="dots", attn_impl="cuda",
        moe=dataclasses.replace(cfg.moe, dropless=False, capacity_factor=1.0, group_tokens=32))


def trainer(steps, ckpt_every=0, dev=None):
    cfg = moe_config()
    dcfg = DataConfig(**DATA)
    if dev is None:
        dev = MemDevice()
        write_synthetic_dataset(dev, "/data", dcfg, 2, 24, vocab_size=cfg.vocab_size)
    ds = ShardedTokenDataset(dev, [f"/data/shard_{i:05d}.rio" for i in range(2)])
    loader = TokenBatchLoader(ds, dcfg, prefetch=False)
    ckpt = CheckpointManager(dev, "/ck", num_shards=2, chunk_bytes=1 << 14) \
        if ckpt_every else None
    tcfg = TrainerConfig(steps=steps, ckpt_every=ckpt_every, log_every=0)
    return dev, Trainer(build_model(cfg), AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8),
                        loader, ckpt, "cpu", tcfg)


@pytest.fixture(scope="module")
def fitted():
    """Three steps with a checkpoint every second step; the spans they left,
    among them a ``remat: recompute`` span that the test opens around
    ``_slots`` wherever a remat recompute runs it again."""
    orig = mlp._slots

    def slots(*a):
        if not recomputing():
            return orig(*a)
        with spans.span("remat: recompute"):
            return orig(*a)

    spans.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mlp, "_slots", slots)
        _, tr = trainer(3, ckpt_every=2)
        out = tr.fit()
    return tr, out, spans.records()


def _steps(recs):
    return sorted((r for r in recs if r.name == "train: step"), key=lambda r: r.t0)


def test_fit_spans_nest_under_each_step_in_order(fitted):
    tr, out, recs = fitted
    roots = _steps(recs)
    assert [r.attrs["step"] for r in roots] == [0, 1, 2]
    for root, ev in zip(roots, tr.events):
        assert root.parent is None and root.root == root.id
        mine = [r for r in recs if r.root == root.id and r is not root]
        kids = sorted((r for r in mine if r.parent is root), key=lambda r: r.t0)
        assert [k.name for k in kids] == PHASES
        assert all(root.t0 <= k.t0 <= k.t1 <= root.t1 for k in mine)
        assert all(a.t1 <= b.t0 for a, b in zip(kids, kids[1:]))
        assert {r.name for r in mine} - set(PHASES) <= {"remat: recompute",
                                                        "plain backward: attention"}
        # the step's own timer is the spans': end of the copy to end of the sync
        moved, synced = kids[1], kids[-1]
        assert ev.seconds == (synced.t1 - moved.t1) / 1e9
    assert set(out["phase_ms"]) == set(PHASES) | {"train: step"}
    for name in ("train: forward", "train: backward", "train: optimizer"):
        assert out["phase_ms"][name]["device"] > 0  # on the CPU, the host's clock
    assert "device" not in out["phase_ms"]["data: load"]


@pytest.mark.parametrize("name", ["plain backward: attention", "remat: recompute"])
def test_backward_children_take_the_backward_of_their_step(fitted, name):
    _, _, recs = fitted
    for root in _steps(recs):
        got = [r for r in recs if r.name == name and r.root == root.id]
        assert got, name
        for r in got:
            assert r.parent.name == "train: backward" and r.parent.parent is root


def test_checkpoint_timers_are_the_spans(fitted):
    tr, out, recs = fitted
    saves = [r for r in recs if r.name == "checkpoint: save"]
    waits = [r for r in recs if r.name == "checkpoint: wait"]
    assert [r.attrs["step"] for r in saves] == [2, 3] and len(waits) == 1
    assert out["ckpt_saves"] == 2
    assert out["ckpt_wait_s"] == pytest.approx(sum(r.seconds for r in saves + waits),
                                               rel=1e-12)


def test_restore_s_is_the_restore_span():
    spans.reset()
    dev, tr = trainer(2, ckpt_every=2)
    tr.fit()
    _, tr2 = trainer(4, ckpt_every=2, dev=dev)
    tr2.fit()
    restored = [r for r in spans.records() if r.name == "checkpoint: restore"]
    assert len(restored) == 2 and tr.restore_s == 0.0
    assert tr2.restore_s == restored[1].seconds > 0


def test_span_on_a_thread_without_context_takes_the_open_home_as_parent():
    """As autograd's device thread does: a span opened on a thread that has
    no current span takes the innermost open home span, and none once it
    has closed."""
    spans.reset()
    got = {}

    def on_thread(key):
        with spans.span("worker") as w:
            with spans.span("inner") as i:
                got[key] = (w, i)

    with spans.span("train: step") as root:
        with spans.span("train: backward", home=True) as bwd:
            t = threading.Thread(target=on_thread, args=("open",))
            t.start()
            t.join(timeout=30)
        assert not t.is_alive()
    t = threading.Thread(target=on_thread, args=("closed",))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    w, i = got["open"]
    assert w.parent is bwd and w.root == root.id and i.parent is w
    w, i = got["closed"]
    assert w.parent is None and w.root == w.id and i.parent is w


def test_ring_keeps_its_bound():
    spans.reset(size=8)
    try:
        for n in range(20):
            with spans.span(f"s{n}"):
                pass
        assert [r.name for r in spans.records()] == [f"s{n}" for n in range(12, 20)]
    finally:
        spans.reset()


def test_profiler_sees_the_spans_that_have_a_parent():
    spans.reset()
    x = torch.ones(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("root"):
            with spans.span("phase one"):
                with spans.span("inner"):
                    (x @ x).sum()
    names = {e.name for e in prof.events()}
    assert {"root", "phase one", "inner"} <= names
    assert "repro_torch.spans: set-up" not in names  # entered before the session records


def test_range_open_across_a_profiler_restart_is_left_safely():
    """A profiler stopped and another started while ranged spans are open
    (as a profiler stepped inside a step does): the spans close in the
    second session, their ranges only once no session records, so that the
    profiler never writes their ends into the first session's freed events
    (which corrupts the heap within a few rounds)."""
    spans.reset()
    x = torch.ones(64, 64)
    for _ in range(20):
        first = profile(activities=[ProfilerActivity.CPU])
        first.start()
        with spans.span("train: step"):
            with spans.span("train: backward"):
                for _ in range(10):
                    x @ x
                first.stop()
                second = profile(activities=[ProfilerActivity.CPU])
                second.start()
                for _ in range(10):
                    x @ x
            with spans.span("train: optimizer"):
                x @ x
        assert len(spans._stale) == 2  # kept while the second session records
        second.stop()
        with spans.span("data: load"):  # no session now: the kept ranges are left
            pass
        assert not spans._stale
        # the first session closed the open ranges at its stop, or dropped
        # them (as torch's version does); the second never saw them
        a = {e.name for e in first.events()}
        b = {e.name for e in second.events()}
        assert "train: optimizer" not in a
        assert "train: optimizer" in b and not {"train: step", "train: backward"} & b
    assert [r.name for r in spans.records()[-4:]] == ["train: backward", "train: optimizer",
                                                      "train: step", "data: load"]


def test_no_profiler_no_record_function(monkeypatch):
    def refuse(name, *a):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    spans.reset()
    _, tr = trainer(2)
    tr.fit()
    assert any(r.name == "plain backward: attention" for r in spans.records())


def _independent_drop_count(model, state, batch):
    """Dropped and routed assignments of the step's forward, from ``_slots``'
    kept mask, with no span and no remat (no grad)."""
    seen = {"dropped": 0, "assignments": 0}
    orig = mlp._slots

    def slots(*a):
        pos, keep = orig(*a)
        seen["dropped"] += int((~keep).sum())
        seen["assignments"] += keep.numel()
        return pos, keep

    mlp._slots = slots
    try:
        with torch.no_grad():
            model.loss(state["params"], batch)
    finally:
        mlp._slots = orig
    return seen


def test_moe_dropped_counts_each_assignment_once_a_step_while_profiling(monkeypatch):
    cfg = moe_config()
    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-3)
    state = make_train_state(model, opt, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 33), generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want = _independent_drop_count(model, state, batch)
    assert want["dropped"] > 0 and want["assignments"] == 4 * 32 * cfg.moe.top_k * cfg.n_layers
    calls = []
    orig = mlp._slots
    monkeypatch.setattr(mlp, "_slots", lambda *a: calls.append(1) or orig(*a))
    step = make_train_step(model, opt)

    spans.reset()
    with spans.span("train: step"):
        step(state, batch)  # no profiler: nothing counts
    assert spans.counters() == {}
    assert len(calls) == 2 * cfg.n_layers  # the forward and the remat recompute

    state = make_train_state(model, opt, torch.Generator().manual_seed(0))
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("train: step"):
            step(state, batch)
    got = spans.counters()
    assert got == {"moe: assignments": want["assignments"], "moe: dropped": want["dropped"]}


def test_generate_loop_spans_share_the_callers_identifier():
    cfg = get_config("tinyllama-1.1b", smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 8),
                                     generator=torch.Generator().manual_seed(1))}
    spans.reset()
    with spans.span("serve: generate") as call:
        make_generate_loop(model, 3)(params, batch, 12)
    mine = sorted((r for r in spans.records() if r.root == call.id and r is not call),
                  key=lambda r: r.t0)
    assert [r.name for r in mine] == (["serve: prefill", "serve: decode"]
                                      + ["serve: decode step"] * 3)
    prefill, loop, steps = mine[0], mine[1], mine[2:]
    assert [r.attrs.get("step") for r in steps] == [0, 1, 2] and loop.attrs["steps"] == 3
    assert prefill.parent is call and loop.parent is call
    assert all(r.parent is loop and r.device_ms is None for r in steps)
    # the device's clock once a loop (on the CPU, the host's), not once a step
    assert prefill.device_ms == prefill.host_ms and loop.device_ms == loop.host_ms


@pytest.mark.cuda
def test_device_spans_never_synchronize(monkeypatch):
    """Device spans record CUDA events and read them only once the caller's
    own synchronisation has passed; the facility itself never waits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    dev = torch.device("cuda")
    x = torch.randn(2048, 2048, device=dev)
    sync = torch.cuda.synchronize

    def refuse(*a, **k):
        raise AssertionError("the facility synchronised")

    for target, name in ((torch.cuda, "synchronize"), (torch.cuda.Event, "synchronize"),
                         (torch.cuda.Event, "wait"), (torch.cuda.Stream, "synchronize"),
                         (torch.Tensor, "item")):
        monkeypatch.setattr(target, name, refuse)
    spans.reset()
    with spans.span("root", device=dev):
        with spans.span("work", device=dev) as work:
            for _ in range(20):
                y = x @ x
        spans.count("device count", (y == y).sum())
        spans.count("device count", 3)
    monkeypatch.undo()
    sync()
    assert work.device_ms > 0 and spans.device_ms_between(work, work) == work.device_ms
    assert spans.counters() == {"device count": 2048 * 2048 + 3}
