"""The port's graph miner (``repro_torch.analysis.mine``) against the
reference's: the twins of ``tests/test_trace_mine.py``, each run on both
packages with the same inputs and their outputs compared, and the
cross-package checks of the mined graphs themselves.

* every twin compares results, trace kinds and arguments, mined
  ``signature()`` and ``to_dot()`` strings, pre-issue schedules (syscalls by
  name) and the class and message of every refusal;
* du and cp traces recorded in each package on identical ``MemDevice``
  workloads mine to identical graphs; ``preissue_overlap`` and
  ``synthesize_trace`` give equal outputs; ``mine_reference_graphs`` gives
  the same signatures;
* ``Foreactor.mine`` returns a ``MinedGraph`` and ``wrap(auto_graph=True)``
  reaches ``'speculating'`` with the serial function's results.
"""

import zlib

import pytest
from _hypothesis_support import given, settings, st
from _torch_twins import T, both, plain, twin


def make_dev(P, nfiles=6, size=32, root="/d"):
    dev = P.MemDevice()
    for i in range(nfiles):
        fd = dev.open(f"{root}/f{i}", "w")
        dev.pwrite(fd, bytes([i % 251]) * size, 0)
        dev.close(fd)
    return dev


def _refusal(fn):
    """(class name, message) of the exception ``fn`` raises."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — compared across the packages
        return type(e).__name__, str(e)
    raise AssertionError("no refusal")


# -- trace recording ---------------------------------------------------------
def test_trace_recorder_records_serial_execution():
    def case(P):
        dev = make_dev(P, 3)
        fa = P.Foreactor(device=dev, backend="io_uring")
        du = fa.observe("du_t", lambda device, root: {"root": root})(P.du_dir)
        total = du(dev, "/d")
        assert total == 3 * 32
        pairs = fa.traces("du_t")
        assert len(pairs) == 1
        ctx, trace = pairs[0]
        assert ctx == {"root": "/d"}
        assert trace.kinds() == [P.Sys.GETDENTS] + [P.Sys.FSTATAT] * 3
        assert trace[0].result == ["f0", "f1", "f2"]
        assert trace[1].args == ("/d/f0",)
        assert fa.total_stats.pre_issued == 0
        fa.shutdown()
        return total, ctx, plain(trace.kinds()), [ev.args for ev in trace.events]

    twin(case)


def test_trace_jsonable_renders_without_blowup():
    def case(P):
        dev = make_dev(P, 3)
        fa = P.Foreactor(device=dev)
        du = fa.observe("du_t", lambda device, root: {"root": root})(P.du_dir)
        du(dev, "/d")
        rows = fa.traces("du_t")[0][1].to_jsonable()
        assert rows[0]["sc"] == "getdents"
        assert all("seq" in r for r in rows)
        fa.shutdown()
        # fstatat results are os.stat_result-like objects rendered by repr
        return [(r["seq"], r["sc"], r["args"], r["error"]) for r in rows]

    twin(case)


# -- mining: structure and provenance ----------------------------------------
def test_mined_du_graph_structure_and_generalization():
    def case(P):
        dev = make_dev(P, 6)
        fa = P.Foreactor(device=dev, backend="io_uring", depth=8)
        du = fa.observe("du_m", lambda device, root: {"root": root})(P.du_dir)
        du(dev, "/d")
        mined = fa.mine("du_m")
        g = mined.graph
        assert set(g.syscall_nodes) == {"getdents", "fstatat"}
        assert g.num_loops == 1
        for i in range(4):
            fd = dev.open(f"/e/x{i}", "w")
            dev.pwrite(fd, b"y" * 8, 0)
            dev.close(fd)
        du_spec = fa.wrap("du_m", lambda device, root: {"root": root})(P.du_dir)
        got = du_spec(dev, "/e")
        assert got == 4 * 8
        assert fa.total_stats.served_async > 0
        fa.shutdown()
        return got, mined.signature(), mined.to_dot()

    twin(case)


def test_mining_is_deterministic():
    def case(P):
        ref1 = P.plugins.mine_reference_graphs()
        ref2 = P.plugins.mine_reference_graphs()
        for key in ("du", "cp"):
            assert ref1[key].signature() == ref2[key].signature()
            assert ref1[key].graph.to_dot() == ref2[key].graph.to_dot()
        return {k: (m.signature(), m.graph.to_dot()) for k, m in ref1.items()}

    twin(case)


def test_validator_refuses_overfit_graph():
    def case(P):
        dev = P.MemDevice()
        for name, size in (("/a", 4 * 1024), ("/b", 3 * 1024 + 100)):
            fd = dev.open(name, "w")
            dev.pwrite(fd, b"z" * size, 0)
            dev.close(fd)
        fa = P.Foreactor(device=dev)
        cap = lambda device, src, dst, buf_size=1024: {  # noqa: E731
            "src": src, "dst": dst, "buf_size": buf_size}
        cp = fa.observe("cp_m", cap)(P.cp_file)
        cp(dev, "/a", "/o1", 1024)
        cp(dev, "/b", "/o2", 1024)
        with pytest.raises(P.UnsoundGraph):
            fa.mine("cp_m")
        out = _refusal(lambda: fa.mine("cp_m"))
        fa.shutdown()
        return out

    assert twin(case)[0] == "UnsoundGraph"


def test_miner_refuses_structural_divergence():
    def case(P):
        dev = make_dev(P, 4)

        def weird(device, mode):
            if mode:
                P.io.getdents(device, "/d")
                for i in range(4):
                    P.io.fstatat(device, f"/d/f{i}")
            else:
                P.io.fstatat(device, "/d/f0")
                P.io.getdents(device, "/d")

        fa = P.Foreactor(device=dev)
        obs = fa.observe("w", lambda device, mode: {})(weird)
        obs(dev, True)
        obs(dev, False)
        with pytest.raises((P.UnminableTrace, P.UnsoundGraph)):
            fa.mine("w")
        out = _refusal(lambda: fa.mine("w"))
        fa.shutdown()
        return out

    twin(case)


def test_miner_refuses_unexplained_argument():
    def case(P):
        dev = P.MemDevice()
        paths = []
        for i in range(5):
            p = f"/h/{zlib.crc32(bytes([i])) % 1000}"
            fd = dev.open(p, "w")
            dev.pwrite(fd, b"q" * 4, 0)
            dev.close(fd)
            paths.append(p)

        def statloop(device):
            for p in paths:
                P.io.fstatat(device, p)

        fa = P.Foreactor(device=dev)
        obs = fa.observe("h", lambda device: {})(statloop)
        obs(dev)
        with pytest.raises(P.UnminableTrace):
            fa.mine("h")
        out = _refusal(lambda: fa.mine("h"))
        fa.shutdown()
        return out

    assert twin(case)[0] == "UnminableTrace"


def test_mined_early_exit_loop_is_weak():
    def case(P):
        dev = make_dev(P, 10)
        fds = [dev.open(f"/d/f{i}", "r") for i in range(10)]
        extents = [[fd, 32, 0] for fd in fds]

        def search(device, extents, stop):
            for i, (fd, n, off) in enumerate(extents):
                data = P.io.pread(device, fd, n, off)
                if i == stop:
                    return data
            return None

        fa = P.Foreactor(device=dev, backend="io_uring", depth=10)
        cap = lambda device, extents, stop: {"extents": extents}  # noqa: E731
        obs = fa.observe("s", cap)(search)
        obs(dev, extents, 6)
        obs(dev, extents, 3)
        obs(dev, extents, 8)
        mined = fa.mine("s")
        (node,) = mined.graph.syscall_nodes.values()
        assert node.out.weak
        spec = fa.wrap("s", cap)(search)
        got = spec(dev, extents, 2)
        assert got == bytes([2]) * 32
        s = fa.total_stats
        assert s.pre_issued > 3
        assert s.cancelled + s.wasted_completions > 0
        fa.shutdown()
        return got, node.out.weak, mined.signature()

    twin(case)


class _SpyBackend:
    """Delegating backend that logs the pre-issue schedule (submit order)."""

    def __init__(self, P, inner):
        self.P = P
        self.inner = inner
        self.prepared = []

    def _log(self, req):
        args = []
        for a in req.args:
            if isinstance(a, self.P.FromRequest):
                args.append("<linked>")
            elif isinstance(a, bytes):
                args.append(("bytes", len(a)))
            else:
                args.append(a)
        self.prepared.append((req.sc, tuple(args)))

    def prepare(self, req):
        self._log(req)
        self.inner.prepare(req)

    def submit(self, batch):
        for req in batch:
            self._log(req)
        return self.inner.submit(batch)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _schedule(P, graph, ctx, dev, fn, *args, depth=16):
    backend = _SpyBackend(P, P.QueuePairBackend(dev, workers=8))
    sess = P.SpecSession(graph, ctx, backend, dev, depth=depth)
    P._session_stack().append(sess)
    try:
        result = fn(*args)
    finally:
        P._session_stack().pop()
        sess.finish()
    backend.shutdown()
    return result, backend.prepared


def test_mined_barrier_keeps_close_at_the_frontier():
    def case(P):
        g = P.plugins.mine_reference_graphs()["cp"].graph
        dev = P.MemDevice()
        fd = dev.open("/src.bin", "w")
        dev.pwrite(fd, bytes(range(256)) * 64, 0)
        dev.close(fd)
        ctx = {"src": "/src.bin", "dst": "/dst.bin", "buf_size": 4096}
        _, prepared = _schedule(P, g, ctx, dev, P.cp_file, dev, "/src.bin", "/dst.bin", 4096)
        kinds = [sc for (sc, _a) in prepared]
        assert P.Sys.CLOSE not in kinds
        assert P.Sys.FSYNC not in kinds
        assert kinds.count(P.Sys.PWRITE) == 4
        f1, f2 = dev.open("/src.bin", "r"), dev.open("/dst.bin", "r")
        assert dev.pread(f1, 16384, 0) == dev.pread(f2, 16384, 0)
        return plain(prepared)

    twin(case)


# -- mined vs hand-written: same pre-issue schedule ---------------------------
def test_mined_du_matches_handwritten_preissue_schedule():
    def case(P):
        ref = P.plugins.mine_reference_graphs()
        hand = P.plugins.build_du_graph()
        dev = make_dev(P, 8, size=24, root="/w")
        r1, sched_hand = _schedule(P, hand, P.plugins.capture_du(dev, "/w"), dev,
                                   P.du_dir, dev, "/w")
        r2, sched_mined = _schedule(P, ref["du"].graph, P.plugins.capture_du(dev, "/w"), dev,
                                    P.du_dir, dev, "/w")
        assert r1 == r2 == 8 * 24
        assert sched_hand == sched_mined
        assert len(sched_hand) > 0
        return r1, plain(sched_hand)

    twin(case)


def test_mined_cp_matches_handwritten_preissue_schedule():
    def case(P):
        ref = P.plugins.mine_reference_graphs()
        hand = P.plugins.build_cp_graph()

        def fresh():
            dev = P.MemDevice()
            fd = dev.open("/s.bin", "w")
            dev.pwrite(fd, bytes(range(256)) * 80, 0)
            dev.close(fd)
            return dev

        dev1, dev2 = fresh(), fresh()
        r1, sched_hand = _schedule(P, hand, P.plugins.capture_cp(dev1, "/s.bin", "/d.bin", 4096),
                                   dev1, P.cp_file, dev1, "/s.bin", "/d.bin", 4096)
        r2, sched_mined = _schedule(P, ref["cp"].graph,
                                    {"src": "/s.bin", "dst": "/d.bin", "buf_size": 4096},
                                    dev2, P.cp_file, dev2, "/s.bin", "/d.bin", 4096)
        assert r1 == r2 == 20480
        assert sched_hand == sched_mined
        assert [sc for (sc, _a) in sched_hand].count(P.Sys.PREAD) == 5
        f1, f2 = dev1.open("/d.bin", "r"), dev2.open("/d.bin", "r")
        out = dev1.pread(f1, 20480, 0)
        assert out == dev2.pread(f2, 20480, 0)
        return r1, plain(sched_hand), zlib.crc32(out)

    twin(case)


# -- auto_graph wrapping ------------------------------------------------------
def test_auto_graph_observes_then_speculates():
    def case(P):
        dev = make_dev(P, 8)
        fa = P.Foreactor(device=dev, backend="io_uring", depth=8)
        du = fa.wrap("du_auto", lambda device, root: {"root": root},
                     auto_graph=True, observe_calls=2)(P.du_dir)
        states = []
        assert du(dev, "/d") == 8 * 32
        states.append(du.__foreactor_auto__["state"])
        assert du(dev, "/d") == 8 * 32
        states.append(du.__foreactor_auto__["state"])
        assert fa.total_stats.pre_issued == 0
        assert du(dev, "/d") == 8 * 32
        assert fa.total_stats.served_async > 0
        fa.shutdown()
        return states

    assert twin(case) == ["observing", "speculating"]


def test_auto_graph_disables_on_unminable_function():
    def case(P):
        dev = make_dev(P, 6)
        flips = {"n": 0}

        def flaky(device):
            flips["n"] += 1
            if flips["n"] % 2:
                P.io.getdents(device, "/d")
            else:
                P.io.fstatat(device, "/d/f0")
                P.io.getdents(device, "/d")
            return flips["n"]

        fa = P.Foreactor(device=dev, backend="io_uring")
        f = fa.wrap("flaky", lambda device: {}, auto_graph=True, observe_calls=2)(flaky)
        f(dev)
        f(dev)
        assert f.__foreactor_auto__["state"] == "disabled"
        assert f.__foreactor_auto__["reason"]
        assert f(dev) == 3
        assert fa.total_stats.pre_issued == 0
        fa.shutdown()
        return dict(f.__foreactor_auto__)

    twin(case)


# -- property-based: mined graphs replay their inputs -------------------------
def _synthetic_traces(P, kind, n_traces, lengths, dev):
    ctxs, traces = [], []
    for t in range(n_traces):
        n = lengths[t]
        paths = []
        for i in range(n):
            p = f"/p{t}/f{i}"
            fd = dev.open(p, "w")
            dev.pwrite(fd, bytes([i % 251]) * 8, 0)
            dev.close(fd)
            paths.append(p)
        rec = P.TraceRecorder(dev)
        P._session_stack().append(rec)
        try:
            if kind == 0:
                ctx = {"paths": paths}
                for p in paths:
                    P.io.fstatat(dev, p)
            elif kind == 1:
                ctx = {"root": f"/p{t}"}
                for name in P.io.getdents(dev, f"/p{t}"):
                    P.io.fstatat(dev, f"/p{t}/{name}")
            else:
                fds = [dev.open(p, "r") for p in paths]
                ctx = {"extents": [[fd, 8, 0] for fd in fds]}
                for fd in fds:
                    P.io.pread(dev, fd, 8, 0)
        finally:
            P._session_stack().pop()
        ctxs.append(ctx)
        traces.append(rec.finish())
    return ctxs, traces


def _mine_twice(P, kind, lengths, name):
    dev = P.MemDevice()
    ctxs, traces = _synthetic_traces(P, kind, len(lengths), lengths, dev)
    m1 = P.mine_traces(traces, ctxs, name=name)
    m2 = P.mine_traces(traces, ctxs, name=name)
    assert m1.signature() == m2.signature()
    assert m1.graph.to_dot() == m2.graph.to_dot()
    for ctx, tr in zip(ctxs, traces):
        P.replay_trace(m1.graph, ctx, tr)
    return m1.signature(), m1.graph.to_dot()


def test_grid_mined_graphs_replay_and_are_deterministic():
    for kind in (0, 1, 2):
        for lengths in ([4], [3, 7], [5, 3, 9], [12]):
            twin(_mine_twice, kind, lengths, "grid")


@settings(max_examples=25, deadline=None)
@given(kind=st.integers(0, 2),
       lengths=st.lists(st.integers(3, 12), min_size=1, max_size=4))
def test_property_mined_graph_replays_every_input_trace(kind, lengths):
    twin(_mine_twice, kind, lengths, "prop")


@settings(max_examples=15, deadline=None)
@given(kind=st.integers(0, 2),
       lengths=st.lists(st.integers(3, 10), min_size=1, max_size=3))
def test_property_mining_twice_is_identical(kind, lengths):
    twin(_mine_twice, kind, lengths, "det")


def _early_exit_case(P, lengths, stops):
    dev = P.MemDevice()
    ctxs, traces = [], []
    for t, (n, stop) in enumerate(zip(lengths, stops)):
        fds = []
        for i in range(n):
            p = f"/q{t}/f{i}"
            fd = dev.open(p, "w")
            dev.pwrite(fd, bytes([i % 251]) * 8, 0)
            dev.close(fd)
            fds.append(dev.open(p, "r"))
        rec = P.TraceRecorder(dev)
        P._session_stack().append(rec)
        try:
            for i, fd in enumerate(fds):
                P.io.pread(dev, fd, 8, 0)
                if i + 1 == stop:
                    break
        finally:
            P._session_stack().pop()
        ctxs.append({"extents": [[fd, 8, 0] for fd in fds]})
        traces.append(rec.finish())
    try:
        mined = P.mine_traces(traces, ctxs, name="exit")
    except P.UnminableTrace as e:
        assert max(len(tr) for tr in traces) < 3
        assert len(traces) >= 2
        return "UnminableTrace", str(e)
    for ctx, tr in zip(ctxs, traces):
        P.replay_trace(mined.graph, ctx, tr)
    return mined.signature(), mined.graph.to_dot()


@settings(max_examples=15, deadline=None)
@given(lengths=st.lists(st.integers(3, 10), min_size=2, max_size=4), exits=st.data())
def test_property_early_exit_traces_replay(lengths, exits):
    stops = [exits.draw(st.integers(1, n)) for n in lengths]
    twin(_early_exit_case, lengths, stops)


# -- cross-package checks -----------------------------------------------------
def _du_cp_traces(P):
    """du over two directories and cp of two files, recorded on one
    ``MemDevice`` workload, and the graphs mined from them."""
    dev = P.MemDevice()
    for d, n in (("/a", 7), ("/b", 4)):
        for i in range(n):
            fd = dev.open(f"{d}/f{i}", "w")
            dev.pwrite(fd, bytes([i + 1]) * (10 + 3 * i), 0)
            dev.close(fd)
    for name, size in (("/s1", 5 * 2048 + 17), ("/s2", 3 * 2048)):
        fd = dev.open(name, "w")
        dev.pwrite(fd, bytes((7 * j) % 256 for j in range(size)), 0)
        dev.close(fd)
    fa = P.Foreactor(device=dev, backend="sync")
    du = fa.observe("du", P.plugins.capture_du)(P.du_dir)
    du(dev, "/a")
    du(dev, "/b")
    cp = fa.observe("cp", lambda device, src, dst, buf_size=2048:
                    P.plugins.capture_cp(device, src, dst, buf_size))(P.cp_file)
    cp(dev, "/s1", "/o1", 2048)
    cp(dev, "/s2", "/o2", 2048)
    traces = {k: fa.traces(k) for k in ("du", "cp")}
    mined = {k: fa.mine(k, register=False) for k in ("du", "cp")}
    fa.shutdown()
    return dev, traces, mined


def test_du_cp_traces_mine_to_identical_graphs_in_both_packages():
    def case(P):
        _dev, traces, mined = _du_cp_traces(P)
        kinds = {k: [plain(t.kinds()) for _c, t in v] for k, v in traces.items()}
        return kinds, {k: (m.signature(), m.to_dot()) for k, m in mined.items()}

    kinds, graphs = twin(case)
    assert kinds["du"][0] == ["getdents"] + ["fstatat"] * 7
    assert "loop0" in graphs["cp"][0]


def test_preissue_overlap_and_synthesize_trace_agree_across_packages():
    def case(P):
        dev, traces, mined = _du_cp_traces(P)
        out = {}
        for k in ("du", "cp"):
            g = mined[k].graph
            out[k] = [P.preissue_overlap(g, dict(c), t) for c, t in traces[k]]
        # a synthetic du of /a replays the recorded one
        synth = P.synthesize_trace(mined["du"].graph, {"root": "/a"}, dev)
        out["synth"] = [(ev.sc.value, ev.args, ev.result if ev.sc.value == "getdents" else
                         ev.result.st_size) for ev in synth.events]
        return out

    out = twin(case)
    assert out["du"] == [8, 5]
    assert len(out["synth"]) == 8


def test_mine_reference_graphs_same_signatures_in_both_packages():
    ref, port = both(lambda P: {k: (m.signature(), m.graph.to_dot(), m.num_traces)
                                for k, m in P.plugins.mine_reference_graphs().items()})
    assert port == ref
    assert set(port) == {"du", "cp"}


# -- Foreactor.mine and auto_graph in the port --------------------------------
def test_foreactor_mine_returns_a_mined_graph():
    dev = make_dev(T, 5)
    fa = T.Foreactor(device=dev, backend="sync")
    du = fa.observe("du_m", T.plugins.capture_du)(T.du_dir)
    du(dev, "/d")
    mined = fa.mine("du_m")
    assert isinstance(mined, T.MinedGraph)
    assert type(mined).__module__ == "repro_torch.analysis.mine"
    assert fa.traces("du_m") == []  # released once the graph is registered
    fa.shutdown()


def test_auto_graph_wrapper_state_is_enabled():
    dev = make_dev(T, 6)
    fa = T.Foreactor(device=dev, backend="io_uring", depth=8)
    du = fa.wrap("du_auto", T.plugins.capture_du, auto_graph=True, observe_calls=2)(T.du_dir)
    du(dev, "/d")
    du(dev, "/d")
    assert du.__foreactor_auto__ == {"state": "speculating", "reason": None}
    fa.shutdown()


def test_auto_graph_results_equal_the_serial_function():
    dev = T.MemDevice()
    for d in range(5):
        for i in range(3 + d):
            fd = dev.open(f"/r{d}/f{i}", "w")
            dev.pwrite(fd, b"x" * (d * 10 + i + 1), 0)
            dev.close(fd)
    serial = [T.du_dir(dev, f"/r{d}") for d in range(5)]
    fa = T.Foreactor(device=dev, backend="io_uring", depth=8)
    du = fa.wrap("du_auto", T.plugins.capture_du, auto_graph=True, observe_calls=2)(T.du_dir)
    assert [du(dev, f"/r{d}") for d in range(5)] == serial
    assert du.__foreactor_auto__["state"] == "speculating"
    assert fa.total_stats.served_async > 0
    fa.shutdown()
