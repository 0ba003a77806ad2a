"""The port's online re-miner (``repro_torch.analysis.remine``) against the
reference's: the twins of ``tests/test_remine.py`` on the deterministic
drift-replay harness (an inline I/O plane, counter-driven decisions), each
run on both packages with the outputs compared, and the whole
``ReMiner.decisions()`` sequence of a seeded drift run (swaps, refusals,
rollbacks) equal across the packages.
"""

import random
import threading

import pytest
from _hypothesis_support import given, settings, st
from _torch_twins import J, T, plain, twin

FILE = "/data/blob"
FILE_BYTES = bytes((i * 31 + 7) % 251 for i in range(1 << 14))

_PLANES = {}


def eager_plane(P, device):
    """A zero-thread plane that executes every admitted request inline at
    submit (errors land in the request, as a lane worker's would)."""
    cls = _PLANES.get(P.root)
    if cls is None:
        class EagerPlane(P.IOPlane):
            def __init__(self, device):
                super().__init__(device, lanes=())
                self.executed = 0

            def _run(self, req):
                if req.claim():
                    try:
                        req.finish(P.perform(self.device, req))
                    except BaseException as e:  # mirror lanes.py worker behaviour
                        req.finish(error=e)
                    self.executed += 1

            def submit(self, batch):
                if not batch:
                    return 0
                with self._lock:
                    self._submitted.extend(batch)
                    if len(self._submitted) > self._LEDGER_COMPACT:
                        self._submitted = [r for r in self._submitted if not r.is_done()]
                for r in batch:
                    self._run(r)
                return len(batch)

            submit_batch = submit

        cls = _PLANES[P.root] = EagerPlane
    return cls(device)


class DriftApp:
    def __init__(self, P, dev, fd):
        self.P = P
        self.dev = dev
        self.fd = fd
        self.count, self.size, self.stride = 4, 256, 512

    def drift(self, count=6, size=128, stride=256):
        self.count, self.size, self.stride = count, size, stride

    def run(self):
        return b"".join(self.P.io.pread(self.dev, self.fd, self.size, i * self.stride)
                        for i in range(self.count))

    def oracle(self):
        return b"".join(self.dev.pread(self.fd, self.size, i * self.stride)
                        for i in range(self.count))


def make_env(P, cfg=None, capacity=64):
    dev = P.MemDevice()
    fd = dev.open(FILE, "w")
    dev.pwrite(fd, FILE_BYTES, 0)
    app = DriftApp(P, dev, fd)
    fa = P.Foreactor(device=dev, backend="io_uring", depth=8, trace_capacity=capacity)
    plane = eager_plane(P, dev)
    fa._backend_pool.backend = plane
    fa._backends.append(plane)
    rm = P.ReMiner(fa, cfg or P.ReMineConfig(sample_every=4, min_traces=3,
                                             remine_every=3, guard_sessions=3),
                   watch=["scan"])
    return dev, app, fa, rm


def _quiet_env(P):
    return make_env(P, P.ReMineConfig(sample_every=10 ** 9, min_traces=3,
                                      remine_every=3, guard_sessions=3))


def bootstrap(fa, app, n=3):
    for _ in range(n):
        fa.record("scan", {}, app.run)


def _counts(st_):
    return (st_.intercepted, st_.pre_issued, st_.served_async, st_.served_sync,
            st_.cancelled, st_.wasted_completions, st_.stale_harvests)


def serve(fa, app, n):
    out = []
    for _ in range(n):
        sess = fa.activate("scan", {})
        try:
            got = app.run()
        finally:
            st_ = fa.deactivate(sess)
        assert got == app.oracle(), "response diverged from sync oracle"
        assert st_.pre_issued == (st_.served_async + st_.cancelled
                                  + st_.wasted_completions), vars(st_)
        out.append(st_)
    return out


def ep_snapshot(rm, name="scan"):
    return rm.snapshot()["endpoints"][name]


# -- the headline: drift -> refusal -> validated hot-swap -> recovery ---------
def test_drift_replay_hot_swap_recovers_speculation():
    def case(P):
        dev, app, fa, rm = make_env(P)
        bootstrap(fa, app)
        assert ep_snapshot(rm)["swaps"] == 1
        pre = serve(fa, app, 8)
        assert sum(s.served_async for s in pre) > 0
        assert sum(s.stale_harvests for s in pre) == 0
        v_before = fa.graph_version("scan")
        app.drift()
        post = serve(fa, app, 16)
        assert sum(s.stale_harvests for s in post) > 0
        acts = [(d["action"], d.get("scope")) for d in rm.decisions()]
        assert ("refuse", None) in acts
        assert ("swap", "suffix") in acts, acts
        rec = serve(fa, app, 6)
        assert fa.graph_version("scan") > v_before
        spec = [s for s in rec if s.pre_issued > 0]
        assert spec and all(s.cancelled + s.wasted_completions == 0 and s.served_async > 0
                            for s in spec)
        stats = fa.plan_cache_stats()["per_graph"]["scan"]
        assert stats["swaps"] == 2 and stats["rollbacks"] == 0
        out = ([_counts(s) for s in pre + post + rec], rm.decisions(), rm.snapshot(),
               fa.graph_version("scan"))
        fa.shutdown()
        return out

    twin(case)


def _drift_scenario(P, seed):
    rng = random.Random(seed)
    dev, app, fa, rm = make_env(P)
    bootstrap(fa, app)
    responses = []
    for phase_ops in (rng.randint(6, 10), 16 + rng.randint(0, 4)):
        for _ in range(phase_ops):
            sess = fa.activate("scan", {})
            try:
                responses.append(app.run())
            finally:
                fa.deactivate(sess)
        app.drift()
    snap = rm.snapshot()
    decisions = rm.decisions()
    fa.shutdown()
    return responses, snap, decisions


def test_swap_decisions_replay_identical_across_runs():
    def case(P):
        r1, s1, _ = _drift_scenario(P, seed=7)
        r2, s2, _ = _drift_scenario(P, seed=7)
        assert r1 == r2
        assert s1 == s2
        assert s1["endpoints"]["scan"]["swaps"] >= 2
        return r1, s1

    twin(case)


@pytest.mark.parametrize("seed", [0, 7, 31])
def test_drift_replay_decision_sequence_equal_across_packages(seed):
    """The same seeded drift run makes the same decisions in both packages:
    every swap, refusal and rollback, with its reason, scope and signature."""
    (rj, sj, dj), (rt, st_, dt) = (_drift_scenario(J, seed), _drift_scenario(T, seed))
    assert rt == rj
    assert dt == dj
    assert st_ == sj
    actions = {d["action"] for d in dt}
    assert {"swap", "refuse"} <= actions


def test_in_flight_session_finishes_on_its_own_plan_across_swap():
    def case(P):
        dev, app, fa, rm = _quiet_env(P)
        bootstrap(fa, app)
        serve(fa, app, 1)
        v1 = fa.graph_version("scan")
        sess = fa.activate("scan", {})
        try:
            first = [P.io.pread(dev, app.fd, app.size, i * app.stride) for i in range(2)]
            fa.swap_graph("scan", fa._graph_builders["scan"])
            rest = [P.io.pread(dev, app.fd, app.size, i * app.stride)
                    for i in range(2, app.count)]
        finally:
            st_ = fa.deactivate(sess)
        assert b"".join(first + rest) == app.oracle()
        assert st_.pre_issued == st_.served_async + st_.cancelled + st_.wasted_completions
        assert sess.graph_version == v1
        serve(fa, app, 1)
        assert fa.graph_version("scan") == v1 + 1
        out = (v1, _counts(st_), fa.graph_version("scan"))
        fa.shutdown()
        return out

    twin(case)


def test_injected_bad_candidate_is_rolled_back_and_vetoed():
    def case(P):
        dev, app, fa, rm = _quiet_env(P)
        bootstrap(fa, app)
        good = serve(fa, app, 4)
        assert sum(s.cancelled + s.wasted_completions for s in good) == 0

        def bad_builder():
            b = P.GraphBuilder("scan")
            prev = None
            for i in range(4):
                node = f"p{i}"
                b.AddSyscallNode(node, P.Sys.PREAD,
                                 lambda ctx, ep, i=i: ((app.fd, 64, 8192 + i), False))
                if prev is not None:
                    b.SyscallSetNext(prev, node, weak=False)
                prev = node
            b.SyscallSetNext(prev, None, weak=True)
            b.SetStart("p0")
            return b.Build()

        rm.inject_candidate("scan", bad_builder, sig="bad-canary")
        stats = fa.plan_cache_stats()["per_graph"]["scan"]
        assert stats["swaps"] == 2 and stats["rollbacks"] == 0
        during = serve(fa, app, 3)
        assert all(s.cancelled + s.wasted_completions > 0 for s in during if s.pre_issued > 0)
        ep = ep_snapshot(rm)
        assert ep["rollbacks"] == 1 and ep["vetoed"] == 1
        assert not ep["guard_active"]
        assert fa.plan_cache_stats()["per_graph"]["scan"]["rollbacks"] == 1
        assert "rollback" in [d["action"] for d in rm.decisions()]
        after = serve(fa, app, 4)
        spec = [s for s in after if s.pre_issued > 0]
        assert spec and all(s.cancelled + s.wasted_completions == 0 for s in spec)
        out = ([_counts(s) for s in good + during + after], rm.decisions(), rm.snapshot())
        fa.shutdown()
        return out

    twin(case)


# -- adversarial drifted/ambiguous evidence -----------------------------------
def test_validator_refuses_loop_count_change_and_keeps_old_graph():
    def case(P):
        dev, app, fa, rm = _quiet_env(P)
        bootstrap(fa, app)
        swaps_before = ep_snapshot(rm)["swaps"]
        v = fa.graph_version("scan")
        fa.record("scan", {}, app.run)
        fa.record("scan", {}, app.run)
        app.count = 6
        fa.record("scan", {}, app.run)
        ep = ep_snapshot(rm)
        assert ep["swaps"] == swaps_before
        assert ep["refusals"].get("shadow", 0) >= 1
        assert fa.graph_version("scan") == v
        out = rm.decisions()
        fa.shutdown()
        return out

    twin(case)


def test_miner_refuses_spurious_branch_in_minority_trace():
    def case(P):
        dev, app, fa, rm = _quiet_env(P)
        bootstrap(fa, app)
        swaps_before = ep_snapshot(rm)["swaps"]

        def with_spurious_stat():
            a = P.io.pread(app.dev, app.fd, app.size, 0)
            P.io.fstatat(app.dev, FILE)
            return a + P.io.pread(app.dev, app.fd, app.size, app.stride)

        def plain_reads():
            return (P.io.pread(app.dev, app.fd, app.size, 0)
                    + P.io.pread(app.dev, app.fd, app.size, app.stride))

        fa.drop_traces("scan")
        fa.record("scan", {}, with_spurious_stat)
        fa.record("scan", {}, plain_reads)
        fa.record("scan", {}, plain_reads)
        ep = ep_snapshot(rm)
        assert ep["swaps"] == swaps_before
        assert ep["refusals"].get("unminable", 0) >= 1
        out = rm.decisions()
        fa.shutdown()
        return out

    twin(case)


def test_miner_refuses_reordered_write_barrier():
    def case(P):
        dev, app, fa, rm = _quiet_env(P)
        bootstrap(fa, app)
        swaps_before = ep_snapshot(rm)["swaps"]
        wfd = dev.open("/data/wal", "w")

        def write_then_sync():
            P.io.pwrite(app.dev, wfd, b"x" * 64, 0)
            P.io.fsync(app.dev, wfd)

        def sync_then_write():
            P.io.fsync(app.dev, wfd)
            P.io.pwrite(app.dev, wfd, b"x" * 64, 0)

        fa.drop_traces("scan")
        fa.record("scan", {}, sync_then_write)
        fa.record("scan", {}, write_then_sync)
        fa.record("scan", {}, write_then_sync)
        ep = ep_snapshot(rm)
        assert ep["swaps"] == swaps_before
        assert ep["refusals"].get("unminable", 0) >= 1
        out = rm.decisions()
        fa.shutdown()
        return out

    twin(case)


# -- mine . replay . mine is a fixed point ------------------------------------
def _fixed_point(P, count, size, stride):
    dev = P.MemDevice()
    fd = dev.open(FILE, "w")
    dev.pwrite(fd, FILE_BYTES, 0)
    app = DriftApp(P, dev, fd)
    app.count, app.size, app.stride = count, size, stride
    fa = P.Foreactor(device=dev, backend="sync")
    for _ in range(3):
        fa.record("scan", {}, app.run)
    pairs = fa.traces("scan")
    g1 = P.mine_and_validate([t for _, t in pairs], [c for c, _ in pairs], name="scan")
    synth = [P.synthesize_trace(g1.graph, {}, dev) for _ in range(3)]
    g2 = P.mine_and_validate(synth, [{} for _ in synth], name="scan")
    assert g2.signature() == g1.signature()
    overlap = P.preissue_overlap(g2.graph, {}, synth[0])
    assert overlap == len(synth[0])
    fa.shutdown()
    return g1.signature(), overlap, [plain((ev.sc, ev.args)) for ev in synth[0].events]


@settings(max_examples=15, deadline=None)
@given(count=st.integers(min_value=3, max_value=7),
       size=st.integers(min_value=1, max_value=64),
       stride=st.integers(min_value=64, max_value=256))
def test_mine_synthesize_mine_fixed_point(count, size, stride):
    twin(_fixed_point, count, size, stride)


# -- invalidate_graph racing in-flight sessions, all backends -----------------
N_FILES = 6
FSIZE = 96

CONFIGS = [
    ("sync", "flat", dict(backend="sync")),
    ("user_threads", "flat", dict(backend="user_threads", workers=4)),
    ("io_uring", "flat", dict(backend="io_uring", workers=4)),
    ("multi_queue", "sharded", dict(backend="multi_queue", workers=2)),
    ("shared", "flat", dict(backend="io_uring", workers=4, shared=True)),
]


def _race_device(P, kind):
    dev = P.ShardedDevice([P.MemDevice() for _ in range(3)]) if kind == "sharded" \
        else P.MemDevice()
    for i in range(N_FILES):
        fd = dev.open(f"/c/f{i}", "w")
        dev.pwrite(fd, bytes((i * 7 + j) % 251 for j in range(FSIZE)), 0)
        dev.close(fd)
    return dev


def _chain_builder(P, fds):
    def build():
        b = P.GraphBuilder("race")
        prev = None
        for i in range(N_FILES):
            node = f"s{i}"
            b.AddSyscallNode(node, P.Sys.PREAD, lambda ctx, ep, i=i: ((fds[i], 32, 0), False))
            if prev is not None:
                b.SyscallSetNext(prev, node, weak=True)
            prev = node
        b.SyscallSetNext(prev, None, weak=True)
        b.SetStart("s0")
        return b.Build()
    return build


@pytest.mark.parametrize("cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_invalidate_races_in_flight_session_on_every_backend(cfg):
    name, kind, kwargs = cfg

    def case(P):
        dev = _race_device(P, kind)
        fds = [dev.open(f"/c/f{i}", "r") for i in range(N_FILES)]
        oracle = [dev.pread(fd, 32, 0) for fd in fds]
        fa = P.Foreactor(device=dev, depth=4, **kwargs)
        fa.register("race", _chain_builder(P, fds))
        a_started, swap_done = threading.Event(), threading.Event()
        a_out, a_stat, a_ver = [], [], []

        def session_a():
            sess = fa.activate("race", {})
            try:
                a_out.append(P.io.pread(dev, fds[0], 32, 0))
                a_started.set()
                swap_done.wait()
                for i in range(1, N_FILES):
                    a_out.append(P.io.pread(dev, fds[i], 32, 0))
            finally:
                a_stat.append(fa.deactivate(sess))
                a_ver.append(sess.graph_version)

        t = threading.Thread(target=session_a)
        t.start()
        a_started.wait()
        v1 = fa.graph_version("race")
        fa.invalidate_graph("race")
        fa.swap_graph("race", _chain_builder(P, fds))
        sess_b = fa.activate("race", {})
        try:
            b_out = [P.io.pread(dev, fds[i], 32, 0) for i in range(N_FILES)]
        finally:
            b_stat = fa.deactivate(sess_b)
        swap_done.set()
        t.join()
        assert a_out == oracle and b_out == oracle
        for s in (a_stat[0], b_stat):
            assert s.pre_issued == s.served_async + s.cancelled + s.wasted_completions, vars(s)
        assert a_ver[0] == v1
        assert sess_b.graph_version == v1 + 1
        fa.shutdown()
        return a_out, b_out, a_ver[0], sess_b.graph_version

    twin(case)


# -- the trace ring bounds memory under sustained sampling --------------------
def test_trace_ring_rejects_degenerate_capacity():
    def case(P):
        with pytest.raises(ValueError) as e:
            P.TraceRing(0)
        return str(e.value)

    twin(case)


def test_trace_ring_bounds_memory_and_counts_drops():
    def case(P):
        ring = P.TraceRing(4)
        for i in range(50):
            ring.append({"i": i}, object())
        assert len(ring) == 4
        assert ring.stats() == {"capacity": 4, "resident": 4, "recorded": 50, "dropped": 46}
        kept = [c["i"] for c, _ in ring.snapshot()]
        assert kept == [46, 47, 48, 49]
        return ring.stats(), kept

    twin(case)


def test_sustained_sampling_is_bounded_and_reported():
    def case(P):
        dev = P.MemDevice()
        fd = dev.open(FILE, "w")
        dev.pwrite(fd, FILE_BYTES, 0)
        app = DriftApp(P, dev, fd)
        fa = P.Foreactor(device=dev, backend="sync", trace_capacity=8)
        for _ in range(40):
            fa.record("scan", {}, app.run)
        assert len(fa.traces("scan")) == 8
        st_ = fa.trace_stats()["scan"]
        assert st_ == {"capacity": 8, "resident": 8, "recorded": 40, "dropped": 32}
        fa.shutdown()
        return st_

    twin(case)


def test_sampled_activations_record_and_stay_correct():
    def case(P):
        dev, app, fa, rm = make_env(P, P.ReMineConfig(sample_every=3, min_traces=99,
                                                      remine_every=99))
        bootstrap(fa, app)
        fa.mine("scan")
        stats = serve(fa, app, 9)
        sampled = [s for s in stats if s.pre_issued == 0 and s.served_sync > 0]
        assert len(fa.traces("scan")) == 3
        assert len(sampled) >= 3
        assert rm.sample("other_endpoint") is False
        out = ([_counts(s) for s in stats], rm.snapshot())
        fa.shutdown()
        return out

    twin(case)
