"""The port's multi-tenant I/O server (``repro_torch.launch.ioserver``)
against the reference's.

* the twins of ``tests/test_openloop.py``: the open-loop utilities, the
  isolated-mode thread budget and the deterministic scheduler harness (a
  zero-thread I/O plane pumped by the test, a ``FakeClock``, a seeded
  interleaver), each run on both packages with the reports compared;
* the twin of ``tests/test_futures.py::test_ioserver_report_surfaces_plan_stats``;
* ``run_openloop`` on both packages: equal on every field that does not
  depend on the host's clock;
* the CLI exits 0 in ``--mode all``, ``--openloop`` and ``--remine``.
"""

import os
import random
import subprocess
import sys
from pathlib import Path

import pytest
from _torch_twins import both, twin

ROOT = Path(__file__).resolve().parent.parent


# -- open-loop utility units --------------------------------------------------
def test_arrival_schedule_is_deterministic_and_well_formed():
    def case(P):
        a = P.ioserver.arrival_schedule(64, 0.5, 2.0, seed=11)
        assert a == P.ioserver.arrival_schedule(64, 0.5, 2.0, seed=11)
        assert a != P.ioserver.arrival_schedule(64, 0.5, 2.0, seed=12)
        times = [t for t, _ in a]
        assert times == sorted(times)
        assert all(0.0 <= t < 2.0 for t in times)
        assert [i for _, i in a] == list(range(len(a)))
        assert 20 <= len(a) <= 140
        return a

    twin(case)


@pytest.mark.parametrize("args", [(1024, 0.35, 2.0, 0), (256, 1.2, 1.0, 7), (8, 3.0, 5.0, 123)])
def test_arrival_schedule_equal_in_both_packages(args):
    sessions, rate, duration, seed = args
    ref, port = both(lambda P: P.ioserver.arrival_schedule(sessions, rate, duration, seed=seed))
    assert port == ref
    assert len(port) > 10


def test_arrival_schedule_zero_rate_is_empty():
    def case(P):
        a, b = P.ioserver.arrival_schedule(0, 1.0, 5.0), P.ioserver.arrival_schedule(10, 0.0, 5.0)
        assert a == b == []
        return a, b

    twin(case)


def test_fake_clock_never_goes_backwards():
    def case(P):
        c = P.ioserver.FakeClock()
        c.advance_to(1.5)
        c.advance_to(0.5)
        assert c.now() == 1.5
        c.advance_to(2.0)
        assert c.now() == 2.0
        return c.now()

    twin(case)


def test_max_inflight_counts_overlap_not_touching_sessions():
    def case(P):
        mi = P.ioserver.max_inflight
        out = [mi([(0, 2), (2, 4)]), mi([(0, 2), (2, 4), (1, 3)]),
               mi([(0, 10), (1, 9), (2, 8)]), mi([])]
        assert out == [1, 2, 3, 0]
        return out

    twin(case)


# -- isolated-mode thread-budget regression -----------------------------------
def test_isolated_workers_keeps_the_historical_8_client_shape():
    def case(P):
        assert P.ioserver.isolated_workers(8) == 8
        return P.ioserver.isolated_workers(8)

    twin(case)


def test_isolated_workers_never_oversubscribes():
    def case(P):
        out = []
        for clients in (1, 2, 4, 8, 16, 32, 64, 128, 256):
            per = P.ioserver.isolated_workers(clients)
            assert 2 <= per <= 8
            assert clients * per <= max(P.ioserver.ISOLATED_THREAD_BUDGET, 2 * clients)
            out.append(per)
        return out, P.ioserver.ISOLATED_THREAD_BUDGET

    twin(case)


def test_make_foreactor_isolated_scales_workers_with_clients():
    def case(P):
        fa = P.ioserver.make_foreactor("isolated", P.MemDevice(), clients=64)
        try:
            assert fa.workers == P.ioserver.isolated_workers(64) == 2
            return fa.workers
        finally:
            fa.shutdown()

    twin(case)


# -- the deterministic scheduler harness --------------------------------------
_CLASSES = {}


def _harness_classes(P):
    """ManualPlane and ManualView of ``P``: admitted requests queue until
    the harness pumps them; demand-promoted ones run inline."""
    if P.root in _CLASSES:
        return _CLASSES[P.root]

    class ManualPlane(P.IOPlane):
        def __init__(self, device):
            super().__init__(device, lanes=())
            self.pending = []
            self.executed = 0

        def _run(self, req):
            if req.claim():
                req.finish(P.perform(self.device, req))
                self.executed += 1

        def submit(self, batch):
            if not batch:
                return 0
            with self._lock:
                self._submitted.extend(batch)
                if len(self._submitted) > self._LEDGER_COMPACT:
                    self._submitted = [r for r in self._submitted if not r.is_done()]
            for r in batch:
                if r.priority >= P.SharedBackend.DEMAND_BOOST:
                    self._run(r)
                else:
                    self.pending.append(r)
            return len(batch)

        submit_batch = submit

        def pump(self, k=None):
            n = 0
            while self.pending and (k is None or n < k):
                self._run(self.pending.pop(0))
                n += 1
            return n

    class ManualView(P.SharedBackend):
        def wait(self, req):
            with self._lock:
                deferred = any(req in chain for chain in self._deferred)
            if not deferred and not req.is_done() and req.state is P.ReqState.PREPARED:
                self.inner._run(req)
            return super().wait(req)

    _CLASSES[P.root] = (ManualPlane, ManualView)
    return _CLASSES[P.root]


def _make_files(dev, n=16, size=64):
    out = []
    for i in range(n):
        fd = dev.open(f"/o/f{i}", "w")
        payload = bytes([(i * 7 + 3) % 251]) * size
        dev.pwrite(fd, payload, 0)
        dev.close(fd)
        out.append((dev.open(f"/o/f{i}", "r"), size, 0, payload))
    return out


def _session_steps(P, idx, rng_seed, plane, sched, dev, graph, files, results):
    _plane_cls, view_cls = _harness_classes(P)
    rng = random.Random(rng_seed)
    k = rng.randrange(2, len(files) + 1)
    extents = rng.sample(files, k)
    stop_at = rng.randrange(len(extents))
    view = view_cls(plane, sched, tenant=f"s{idx}", weight=1.0 + (idx % 3),
                    priority=("low", "normal", "high")[idx % 3])
    sess = P.SpecSession(graph, {"extents": [e[:3] for e in extents]}, view, dev, depth=4)
    try:
        for j, (fd, n, off, payload) in enumerate(extents):
            data = sess.intercept(P.Sys.PREAD, (fd, n, off))
            assert data == payload, f"session {idx} read corrupt bytes"
            if j == stop_at:
                break
            yield
    finally:
        stats = sess.finish()
        view.shutdown()
        results.append(stats)


def run_trace(P, sessions, rate, duration, capacity=12, seed=0, arrival_bias=0.85):
    plane_cls, _view_cls = _harness_classes(P)
    dev = P.MemDevice()
    files = _make_files(dev)
    plane = plane_cls(dev)
    sched = P.SlotScheduler(capacity)
    graph = P.build_pread_extents_graph("openloop_scan", weak=True)
    schedule = P.ioserver.arrival_schedule(sessions, rate, duration, seed=seed)
    assert schedule, "empty trace: nothing to test"
    clock = P.ioserver.FakeClock()
    rng = random.Random(seed)
    results, live, events = [], [], []
    peak_live = ai = 0
    while ai < len(schedule) or live:
        if ai < len(schedule) and (not live or rng.random() < arrival_bias):
            t_arr, idx = schedule[ai]
            ai += 1
            clock.advance_to(t_arr)
            g = _session_steps(P, idx, seed * 1000003 + idx, plane, sched, dev, graph, files,
                               results)
            try:
                next(g)
            except StopIteration:
                events.append((t_arr, clock.now()))
            else:
                live.append((g, t_arr))
                peak_live = max(peak_live, len(live))
        else:
            plane.pump(rng.randrange(0, 3))
            i = rng.randrange(len(live))
            g, t_arr = live[i]
            try:
                next(g)
            except StopIteration:
                live.pop(i)
                events.append((t_arr, clock.now()))
    plane.pump()
    total = P.SessionStats()
    for s in results:
        total.merge(s)
    return {"arrivals": len(schedule), "finished": len(results), "peak_live": peak_live,
            "max_inflight_virtual": P.ioserver.max_inflight(events), "stats": total,
            "scheduler": sched.snapshot(), "plane": plane, "events": events}


COUNTS = ("intercepted", "pre_issued", "submits", "served_async", "served_sync", "cancelled",
          "wasted_completions")


def _comparable(rep):
    """The harness report without its objects: every field is deterministic."""
    out = {k: v for k, v in rep.items() if k not in ("stats", "plane")}
    out["stats"] = {f: getattr(rep["stats"], f) for f in COUNTS}
    out["executed"] = rep["plane"].executed
    return out


def _check_invariants(rep):
    assert rep["finished"] == rep["arrivals"], "a session never finished"
    snap = rep["scheduler"]
    assert snap["max_spec_inflight"] <= snap["capacity"], snap
    assert snap["spec_inflight"] == 0, snap
    assert snap["tenants"] == 0, snap
    s = rep["stats"]
    assert s.pre_issued == s.served_async + s.cancelled + s.wasted_completions, vars(s)
    assert s.served_async > 0, "speculation never overlapped anything"
    assert snap["admitted"] > 0 and snap["evictions"] >= 0
    assert not rep["plane"].pending
    assert rep["plane"].inflight() == 0


def test_scheduler_harness_small_trace_tier1():
    def case(P):
        rep = run_trace(P, sessions=128, rate=1.0, duration=1.0, capacity=12, seed=3)
        assert rep["arrivals"] >= 64
        assert rep["peak_live"] >= 32
        _check_invariants(rep)
        return _comparable(rep)

    twin(case)


def test_scheduler_harness_replays_identically():
    def case(P):
        a = run_trace(P, sessions=64, rate=1.0, duration=1.0, capacity=8, seed=9)
        b = run_trace(P, sessions=64, rate=1.0, duration=1.0, capacity=8, seed=9)
        assert _comparable(a) == _comparable(b)
        return _comparable(a)

    twin(case)


def test_scheduler_harness_tiny_capacity_still_drains():
    def case(P):
        rep = run_trace(P, sessions=48, rate=1.0, duration=1.0, capacity=1, seed=5)
        snap = rep["scheduler"]
        assert rep["finished"] == rep["arrivals"]
        assert snap["max_spec_inflight"] <= 1
        assert snap["spec_inflight"] == 0 and snap["tenants"] == 0
        s = rep["stats"]
        assert s.pre_issued == s.served_async + s.cancelled + s.wasted_completions
        return _comparable(rep)

    twin(case)


@pytest.mark.stress
def test_scheduler_harness_1k_sessions():
    def case(P):
        rep = run_trace(P, sessions=1024, rate=1.2, duration=1.0, capacity=24, seed=7,
                        arrival_bias=0.9)
        assert rep["arrivals"] >= 1000
        assert rep["peak_live"] >= 1000, rep["peak_live"]
        _check_invariants(rep)
        return _comparable(rep)

    twin(case)


@pytest.mark.parametrize("seed", [1, 2, 4])
def test_fake_clock_harness_reports_equal_across_packages(seed):
    """The FakeClock harness's whole report (admissions, evictions, stats,
    the virtual-time event log) is the same in both packages."""
    ref, port = both(lambda P: _comparable(run_trace(P, sessions=96, rate=1.0, duration=1.0,
                                                     capacity=6, seed=seed)))
    assert port == ref
    assert port["scheduler"]["admitted"] > 0 and port["events"]


# -- the serving report -------------------------------------------------------
def test_ioserver_report_surfaces_plan_stats():
    def case(P):
        io = P.ioserver
        store = io.build_store(n_keys=200, l0_tables=2, ckpt_chunks=2)
        specs = io.get_clients(1, ops=3) + io.multiget_clients(1, ops=2, batch=4)
        report = io.run_serving("shared", specs, store=store)
        assert report["errors"] == 0
        per = report["plans"]["per_graph"]
        for name in ("lsm_get", "lsm_multiget"):
            assert per[name]["probes"] >= 1, report["plans"]
            assert per[name]["graph_version"] >= 1
        assert report["plans"]["global"]["compiles"] >= 1
        return (report["errors"], report["clients"], sorted(per),
                {c: v["ops"] for c, v in report["per_client"].items()},
                {n: p["graph_version"] for n, p in per.items()},
                report["scheduler"]["capacity"], report["remine"])

    twin(case)


def test_build_store_equal_in_both_packages():
    ref, port = both(lambda P: P.ioserver.build_store(n_keys=300, l0_tables=3, ckpt_chunks=2))
    assert port[1] == ref[1]
    assert sorted(port[0]._files) == sorted(ref[0]._files)
    assert all(bytes(port[0]._files[p]) == bytes(ref[0]._files[p]) for p in ref[0]._files)


def test_run_openloop_deterministic_fields_equal_across_packages():
    """The wall-clock open loop on both packages: the fields that do not
    depend on the host's clock are equal; latencies and rates are not
    compared."""
    def case(P):
        io = P.ioserver
        store = io.build_store(n_keys=300, l0_tables=3, ckpt_chunks=2)
        rep = io.run_openloop("shared", 24, 1.0, 0.5, store=store, server_threads=8)
        assert rep["errors"] == 0 and rep["completed"] == rep["arrivals"]
        assert rep["scheduler"]["spec_inflight"] == 0
        return {k: rep[k] for k in ("mode", "sessions", "rate_per_session", "duration_s",
                                    "arrivals", "offered_rate", "completed", "errors",
                                    "server_threads")}

    twin(case)


# -- the CLI ------------------------------------------------------------------
@pytest.mark.parametrize("args", [
    ["--mode", "all", "--clients", "2", "--ops", "4"],
    ["--openloop", "--mode", "shared", "--sessions", "32", "--rate", "0.5", "--duration", "0.5"],
    ["--remine", "--clients", "2", "--ops", "6"],
], ids=["all", "openloop", "remine"])
def test_cli_exits_zero(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.ioserver", *args], env=env,
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr
    tag = "[openloop]" if "--openloop" in args else "[ioserver]"
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith(tag)]
    assert lines and all("errors=0" in ln for ln in lines), res.stdout
    assert len(lines) == (3 if "all" in args else 1)
    if "--remine" in args:
        assert "  remine lsm_get" in res.stdout
