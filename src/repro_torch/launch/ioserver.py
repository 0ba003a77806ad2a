"""Multi-tenant I/O request server: closed-loop clients and an open-loop
session stream (the shared-backend serving workloads).

Many concurrent clients — each a *tenant* with a priority class and weight —
hammer one storage substrate through two request types:

* ``get``      — LSM point lookup (paper Fig. 4c: the candidate pread chain
  with early exit), speculated through ``plugins.build_lsm_get_graph``;
* ``restore``  — checkpoint-restore scan (open_list + pread_extents over
  every chunk of a step), the framework-plane bulk-read path.

Three serving modes compare arbitration strategies on identical hardware:

* ``sync``     — no speculation (baseline);
* ``isolated`` — the paper's setup: every client thread owns a private
  queue pair and speculates independently (no arbitration);
* ``shared``   — ONE queue pair for everyone; a
  :class:`repro_torch.core.backends.SlotScheduler` leases submission slots
  weighted-fairly across tenants, with priority classes and
  pressure-triggered cancellation of speculative-only requests.

Two load-generation disciplines share that substrate:

* **closed loop** (:func:`run_serving`) — each client issues its next
  request only after the previous one completed.  Simple, but it
  structurally hides queueing collapse: an overloaded server slows its own
  clients down, so offered load self-throttles to capacity.
* **open loop** (:func:`run_openloop`) — requests arrive on a fixed,
  precomputed schedule (:func:`arrival_schedule`) regardless of how the
  server is doing, each arrival a *fresh tenant session*; latency is
  measured from the *scheduled arrival time* (wrk2-style, so coordinated
  omission cannot flatter the tail) and the in-flight session count is
  recovered post hoc from the (arrival, completion) event log.  Pushing the
  arrival rate past capacity exposes the saturation knee the paper's
  serving claim lives on.

    PYTHONPATH=src python -m repro_torch.launch.ioserver --mode shared --clients 8
    PYTHONPATH=src python -m repro_torch.launch.ioserver --mode all --clients 8
    PYTHONPATH=src python -m repro_torch.launch.ioserver --openloop --mode shared \\
        --sessions 1024 --rate 0.35 --duration 2.0
"""

from __future__ import annotations

import argparse
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import (DeviceProfile, Foreactor, MemDevice, SimulatedDevice,
                        io)
from repro_torch.core.patterns import build_pread_extents_graph
from repro_torch.store import plugins
from repro_torch.store.lsm import LSMTree

#: serving-tier device: ms-scale per-op latency, far above both CI sleep
#: granularity and the engine's per-intercept CPU cost (the benchmark runs
#: on 2-vCPU containers — a faster synthetic device would measure GIL
#: contention, not I/O arbitration), with enough internal parallelism that
#: the scheduler, not the device, decides who waits.
SERVE_PROFILE = DeviceProfile(channels=32, base_latency=5.0e-3,
                              metadata_latency=4.0e-3, per_byte=2.0e-10,
                              crossing_cost=4e-6)

#: speculation depth for the speculating modes.  The LSM get chain exits
#: early (~half its ~8 candidates): depth 16 would waste ~2x the device's
#: work at scale, the adaptive controller whipsaws when 8 concurrent
#: sessions with different exit points feed one per-graph controller — a
#: fixed moderate pipeline width is the serving sweet spot (docs/TUNING.md,
#: "Priority mixes on a shared backend").
SERVE_DEPTH = 4
#: shared-pool sizing: workers stay below the device's channel count so
#: demand I/O always finds free channels even when every worker is busy
#: running speculation, while the scheduler's slot window is a bit wider —
#: slots above the worker count queue as PREPARED entries, which is exactly
#: the state pressure eviction can cancel.
SHARED_WORKERS = 24
SHARED_SLOTS = 32
#: isolated mode gives every client thread a private queue pair; the
#: worker-thread budget is fixed for the whole experiment and divided
#: across clients by :func:`isolated_workers`.  (The original code
#: hard-coded 8 workers per client — an "8 clients × 8 = 64 threads"
#: assumption that oversubscribed badly once ``--clients`` grew: 64 clients
#: would have spawned 512 worker threads.)
ISOLATED_THREAD_BUDGET = 64


def isolated_workers(clients: int) -> int:
    """Per-client queue-pair size in isolated mode: the fixed
    :data:`ISOLATED_THREAD_BUDGET` split across clients, clamped to [2, 8]
    (8 matches the historical 8-client benchmark shape; below 2 a queue
    pair cannot overlap anything)."""
    return max(2, min(8, ISOLATED_THREAD_BUDGET // max(1, clients)))


@dataclass
class ClientSpec:
    """One closed-loop client: its tenant identity and request mix."""

    name: str
    workload: str = "get"  # "get" | "multiget" | "restore"
    priority: str = "normal"  # "high" | "normal" | "low"
    weight: float = 1.0
    ops: int = 60
    warmup: int = 3  # leading ops excluded from latency stats
    batch: int = 8  # keys per op for the "multiget" workload


@dataclass
class ClientResult:
    spec: ClientSpec
    latencies_s: List[float] = field(default_factory=list)
    errors: int = 0


def percentile(xs: List[float], q: float) -> float:
    if not xs:
        return float("nan")
    return float(np.percentile(np.asarray(xs), q))


# -- workload construction ----------------------------------------------------

def build_store(n_keys: int = 2000, record: int = 128, l0_tables: int = 8,
                ckpt_chunks: int = 16, seed: int = 0):
    """Build the LSM database and a small checkpoint on a raw MemDevice
    (no latency during setup); returns (inner, reference dict)."""
    rng = np.random.default_rng(seed)
    inner = MemDevice()
    per_table = max(1, n_keys // l0_tables)
    limit = per_table * (record + 12)
    lsm = LSMTree(inner, "/db", memtable_limit_bytes=limit, l0_limit=10 ** 6,
                  fsync_writes=False)
    ref: Dict[int, bytes] = {}
    payload = rng.bytes(record)
    for k in rng.permutation(n_keys):
        v = int(k).to_bytes(8, "little") + payload[:-8]
        lsm.put(int(k), v)
        ref[int(k)] = v
    lsm.flush()
    lsm.close()
    # checkpoint chunks for the restore path: one file of ckpt_chunks extents
    fd = inner.open("/ck/blob.bin", "w")
    inner.pwrite(fd, rng.bytes(ckpt_chunks * 16384), 0)
    inner.close(fd)
    return inner, ref


def restore_extents(dev, n_chunks: int = 16, chunk: int = 16384):
    fd = dev.open("/ck/blob.bin", "r")
    return [(fd, chunk, i * chunk) for i in range(n_chunks)]


def make_foreactor(mode: str, dev, depth=SERVE_DEPTH,
                   clients: int = 8, remine: bool = False) -> Foreactor:
    if mode == "sync":
        fa = Foreactor(device=dev, backend="sync", depth=0)
    elif mode == "isolated":
        fa = Foreactor(device=dev, backend="io_uring", depth=depth,
                       workers=isolated_workers(clients))
    elif mode == "shared":
        fa = Foreactor(device=dev, backend="io_uring", depth=depth,
                       workers=SHARED_WORKERS, shared=True,
                       shared_slots=SHARED_SLOTS)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    # warm the plan cache before the first client request: first-request
    # latency should pay a dict probe, not a graph build + lowering
    plugins.register_all(fa, precompile=True)
    fa.register("restore_scan",
                lambda: build_pread_extents_graph("restore_scan"))
    fa.plan("restore_scan")
    if remine and mode != "sync":
        # online re-mining on the hot endpoint: sampled activations record
        # traces, validated candidates hot-swap, regressions roll back —
        # swaps/rollbacks surface in the serving report's plan lines
        from repro_torch.analysis.remine import ReMiner
        ReMiner(fa, watch=["lsm_get"])
    return fa


# -- the serving loop ---------------------------------------------------------

def _client_loop(fa: Foreactor, dev, lsm: LSMTree, ref: Dict[int, bytes],
                 spec: ClientSpec, result: ClientResult,
                 start_gate: threading.Event, seed: int) -> None:
    """Closed loop: the next request starts only after the previous one's
    session is fully torn down (cancel + drain — that cost lands in
    throughput), but *latency* is recorded at response time, when the
    result is in hand: a server answers the client before it cleans up its
    speculation leftovers."""
    rng = np.random.default_rng(seed)
    extents = restore_extents(dev)
    keys = rng.integers(0, len(ref), size=spec.ops + spec.warmup)
    # drawn after `keys` so get/restore clients' random streams are
    # unchanged by the multiget op class existing
    mkeys = rng.integers(0, len(ref),
                         size=(spec.ops + spec.warmup) * spec.batch) \
        if spec.workload == "multiget" else None
    with fa.tenant(spec.name, weight=spec.weight, priority=spec.priority):
        start_gate.wait()
        for i in range(spec.ops + spec.warmup):
            t0 = time.perf_counter()
            dt = None
            try:
                if spec.workload == "get":
                    key = int(keys[i])
                    sess = fa.activate("lsm_get",
                                       plugins.capture_lsm_get(lsm, key))
                    try:
                        v = lsm.get(key)
                        dt = time.perf_counter() - t0  # response latency
                    finally:
                        fa.deactivate(sess)
                    if v != ref[key]:
                        result.errors += 1
                elif spec.workload == "multiget":
                    # scatter-gather op class: one N-key batch per request,
                    # one generated plan per batch (the futures fan-out)
                    batch = [int(k) for k in
                             mkeys[i * spec.batch:(i + 1) * spec.batch]]
                    sess = fa.activate(
                        "lsm_multiget",
                        plugins.capture_lsm_multiget(lsm, batch))
                    try:
                        vs = lsm.multi_get(batch)
                        dt = time.perf_counter() - t0
                    finally:
                        fa.deactivate(sess)
                    if vs != [ref.get(k) for k in batch]:
                        result.errors += 1
                else:
                    sess = fa.activate("restore_scan", {"extents": extents})
                    try:
                        for fd, n, off in extents:
                            io.pread(dev, fd, n, off)
                        dt = time.perf_counter() - t0
                    finally:
                        fa.deactivate(sess)
            except Exception:
                result.errors += 1
                dt = time.perf_counter() - t0
            if i >= spec.warmup:
                result.latencies_s.append(dt)


def run_serving(mode: str, clients: List[ClientSpec],
                profile: DeviceProfile = SERVE_PROFILE,
                seed: int = 0, store=None, remine: bool = False) -> dict:
    """Run one closed-loop serving experiment; returns the report dict."""
    inner, ref = store if store is not None else build_store(seed=seed)
    dev = SimulatedDevice(inner, profile)
    fa = make_foreactor(mode, dev, clients=len(clients), remine=remine)
    lsm = LSMTree.open_existing(dev, "/db", fsync_writes=False)
    results = [ClientResult(spec=c) for c in clients]
    start_gate = threading.Event()
    threads = [
        threading.Thread(target=_client_loop, name=c.name,
                         args=(fa, dev, lsm, ref, c, r, start_gate, seed + i))
        for i, (c, r) in enumerate(zip(clients, results))
    ]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    start_gate.set()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    lsm.close()
    fa.shutdown()

    per_client = {}
    by_class: Dict[str, List[float]] = {}
    total_ops = 0
    total_errors = 0
    for r in results:
        lat = r.latencies_s
        total_ops += len(lat)
        total_errors += r.errors
        per_client[r.spec.name] = {
            "workload": r.spec.workload,
            "priority": r.spec.priority,
            "ops": len(lat),
            "errors": r.errors,
            "p50_ms": percentile(lat, 50) * 1e3,
            "p99_ms": percentile(lat, 99) * 1e3,
        }
        by_class.setdefault(r.spec.priority, []).extend(lat)
    report = {
        "mode": mode,
        "clients": len(clients),
        "wall_s": wall,
        "throughput_ops": total_ops / wall if wall > 0 else 0.0,
        "errors": total_errors,
        "per_client": per_client,
        "classes": {
            prio: {"ops": len(lat),
                   "p50_ms": percentile(lat, 50) * 1e3,
                   "p99_ms": percentile(lat, 99) * 1e3}
            for prio, lat in by_class.items()
        },
        "scheduler": fa.scheduler.snapshot() if fa.scheduler else None,
        # plan-cache + mined-graph-version observability (per endpoint):
        # thrash shows as compiles tracking probes instead of hits
        "plans": fa.plan_cache_stats(),
        # online re-mining activity: sampling/attempt/swap/rollback counters
        # and the deterministic decision log (None when --remine is off)
        "remine": fa.reminer.snapshot() if fa.reminer else None,
    }
    return report


def get_clients(n: int, priority: str = "normal", ops: int = 60,
                prefix: str = "get") -> List[ClientSpec]:
    return [ClientSpec(name=f"{prefix}-{i}", workload="get",
                       priority=priority, ops=ops) for i in range(n)]


def multiget_clients(n: int, priority: str = "normal", ops: int = 20,
                     batch: int = 8,
                     prefix: str = "multiget") -> List[ClientSpec]:
    """Scatter-gather clients: each op is one ``batch``-key multiget served
    by a single generated ``lsm_multiget`` plan."""
    return [ClientSpec(name=f"{prefix}-{i}", workload="multiget",
                       priority=priority, ops=ops, batch=batch, warmup=1)
            for i in range(n)]


def restore_clients(n: int, priority: str = "low", ops: int = 12,
                    prefix: str = "restore") -> List[ClientSpec]:
    # background bulk work: low priority class AND low weight — its fair
    # share stays small enough that the workers it occupies never crowd out
    # the hot tenants' speculation (docs/TUNING.md "Priority mixes")
    return [ClientSpec(name=f"{prefix}-{i}", workload="restore",
                       priority=priority, weight=0.25, ops=ops, warmup=1)
            for i in range(n)]


# -- open-loop load generation ------------------------------------------------

#: server-side worker threads draining the open-loop arrival queue.  This is
#: the service capacity knob, NOT the concurrency cap on sessions: arrivals
#: past it queue (that queueing *is* the measurement), and in-flight
#: sessions — arrived, not yet completed — run into the thousands once the
#: arrival rate passes the knee.
OPENLOOP_SERVER_THREADS = 32


class FakeClock:
    """Deterministic clock for the seeded scheduler harness
    (tests/test_openloop.py): time advances only when the test says so, so
    a 1k-session trace replays identically on every run with zero
    wall-clock sleeps."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def now(self) -> float:
        return self.t

    def advance_to(self, t: float) -> None:
        """Jump forward to ``t`` (never backwards — arrivals are sorted)."""
        if t > self.t:
            self.t = float(t)


def arrival_schedule(sessions: int, rate_per_session: float,
                     duration_s: float, seed: int = 0) -> List[tuple]:
    """Seeded open-loop arrival trace.

    ``sessions`` independent tenants each issue requests as a Poisson
    process of ``rate_per_session`` per second; the superposition is one
    Poisson stream at the aggregate rate, which is how we draw it.  Every
    arrival is a *fresh* session (activate -> serve -> deactivate), so the
    trace exercises the scheduler's whole tenant lifecycle, not just its
    steady state.  Returns a time-sorted list of ``(arrival_s,
    session_idx)`` covering ``[0, duration_s)``; the same seed always
    yields the identical trace (the deterministic test harness and the
    benchmark share this generator).
    """
    rng = np.random.default_rng(seed)
    rate = float(sessions) * float(rate_per_session)
    if rate <= 0:
        return []
    out: List[tuple] = []
    t = 0.0
    idx = 0
    while True:
        t += float(rng.exponential(1.0 / rate))
        if t >= duration_s:
            return out
        out.append((t, idx))
        idx += 1


def max_inflight(events: List[tuple]) -> int:
    """Peak concurrent sessions from (arrival_s, completion_s) pairs: the
    classic +1/-1 sweep (completions sort before arrivals at a tie — a
    session that ends the instant another starts does not overlap it)."""
    marks = [(t, 1) for t, _ in events] + [(d, -1) for _, d in events]
    marks.sort(key=lambda m: (m[0], m[1]))
    cur = peak = 0
    for _t, delta in marks:
        cur += delta
        peak = max(peak, cur)
    return peak


def run_openloop(mode: str, sessions: int, rate_per_session: float,
                 duration_s: float, profile: DeviceProfile = SERVE_PROFILE,
                 seed: int = 0, store=None,
                 server_threads: int = OPENLOOP_SERVER_THREADS) -> dict:
    """One open-loop cell: replay a fixed arrival schedule against one
    serving mode and report achieved throughput, virtual-time latency
    percentiles, and the peak in-flight session count.

    Latency is virtual-time (wrk2's correction for coordinated omission):
    measured from each request's *scheduled* arrival, not from when a
    server thread finally picked it up — so when the server falls behind,
    the queueing delay lands in the tail instead of silently stretching
    the load generator.
    """
    inner, ref = store if store is not None else build_store(seed=seed)
    dev = SimulatedDevice(inner, profile)
    fa = make_foreactor(mode, dev, clients=server_threads)
    lsm = LSMTree.open_existing(dev, "/db", fsync_writes=False)
    schedule = arrival_schedule(sessions, rate_per_session, duration_s, seed)
    rng = np.random.default_rng(seed + 1)
    keys = rng.integers(0, len(ref), size=max(1, len(schedule)))
    n = len(schedule)
    events: List[Optional[tuple]] = [None] * n
    latencies: List[Optional[float]] = [None] * n
    cursor = [0]
    errors = [0]
    lock = threading.Lock()

    # warm the serving path before the clock starts (plan cache is already
    # precompiled; this pulls the LSM filters/index blocks and the first
    # worker wakeups out of the measured window — without it the first few
    # arrivals eat cold-start cost and pollute the low-rate cells' p99)
    for key in map(int, keys[: min(4, len(keys))]):
        with fa.tenant("warmup", priority="normal"):
            sess = fa.activate("lsm_get", plugins.capture_lsm_get(lsm, key))
            try:
                lsm.get(key)
            finally:
                fa.deactivate(sess)

    t0 = time.monotonic() + 0.02  # small lead so arrival 0 is in the future

    def server() -> None:
        while True:
            with lock:
                i = cursor[0]
                if i >= n:
                    return
                cursor[0] = i + 1
            t_arr, idx = schedule[i]
            delay = (t0 + t_arr) - time.monotonic()
            if delay > 0:  # ahead of schedule: hold the arrival back
                time.sleep(delay)
            key = int(keys[i])
            t_resp = None
            try:
                with fa.tenant(f"s{idx}", priority="normal"):
                    sess = fa.activate("lsm_get",
                                       plugins.capture_lsm_get(lsm, key))
                    try:
                        v = lsm.get(key)
                        t_resp = time.monotonic()
                        if v != ref[key]:
                            with lock:
                                errors[0] += 1
                    finally:
                        fa.deactivate(sess)
            except Exception:
                with lock:
                    errors[0] += 1
            t_done = time.monotonic()
            if t_resp is None:
                t_resp = t_done
            events[i] = (t_arr, t_done - t0)
            latencies[i] = (t_resp - t0) - t_arr

    threads = [threading.Thread(target=server, name=f"openloop-{i}")
               for i in range(server_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    lsm.close()
    sched_snap = fa.scheduler.snapshot() if fa.scheduler else None
    plans_snap = fa.plan_cache_stats()
    fa.shutdown()

    lat = [x for x in latencies if x is not None]
    evs = [e for e in events if e is not None]
    last_done = max((d for _, d in evs), default=duration_s)
    offered = n / duration_s if duration_s > 0 else 0.0
    achieved = len(evs) / last_done if last_done > 0 else 0.0
    return {
        "mode": mode,
        "sessions": sessions,
        "rate_per_session": rate_per_session,
        "duration_s": duration_s,
        "arrivals": n,
        "offered_rate": offered,
        "achieved_rate": achieved,
        "completed": len(evs),
        "errors": errors[0],
        "p50_ms": percentile(lat, 50) * 1e3,
        "p99_ms": percentile(lat, 99) * 1e3,
        "max_inflight_sessions": max_inflight(evs),
        "server_threads": server_threads,
        "scheduler": sched_snap,
        "plans": plans_snap,
    }


def _print_report(rep: dict) -> None:
    print(f"[ioserver] mode={rep['mode']} clients={rep['clients']} "
          f"wall={rep['wall_s']:.2f}s tput={rep['throughput_ops']:.0f} op/s "
          f"errors={rep['errors']}")
    for prio, c in sorted(rep["classes"].items()):
        print(f"  class {prio:7s} ops={c['ops']:4d} "
              f"p50={c['p50_ms']:.2f}ms p99={c['p99_ms']:.2f}ms")
    if rep["scheduler"]:
        print(f"  scheduler: {rep['scheduler']}")
    plans = rep.get("plans") or {}
    for name, p in sorted(plans.get("per_graph", {}).items()):
        print(f"  plan {name:14s} probes={p['probes']:3d} "
              f"hits={p['hits']:3d} compiles={p['compiles']} "
              f"graph_v{p['graph_version']} swaps={p.get('swaps', 0)} "
              f"rollbacks={p.get('rollbacks', 0)}")
    rm = rep.get("remine")
    if rm:
        for name, ep in sorted(rm["endpoints"].items()):
            print(f"  remine {name:12s} samples={ep['samples']:3d} "
                  f"attempts={ep['attempts']} swaps={ep['swaps']} "
                  f"rollbacks={ep['rollbacks']} "
                  f"refusals={sum(ep['refusals'].values())}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="shared",
                    choices=["sync", "isolated", "shared", "all"])
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--ops", type=int, default=60)
    ap.add_argument("--low-pri-restores", type=int, default=0,
                    help="add N low-priority restore clients")
    ap.add_argument("--multigets", type=int, default=0,
                    help="add N scatter-gather multiget clients "
                         "(8-key batches)")
    ap.add_argument("--remine", action="store_true",
                    help="attach the online re-miner to the lsm_get "
                         "endpoint (closed-loop modes)")
    ap.add_argument("--openloop", action="store_true",
                    help="open-loop session stream instead of closed-loop "
                         "clients")
    ap.add_argument("--sessions", type=int, default=256,
                    help="(openloop) tenant sessions driving the arrivals")
    ap.add_argument("--rate", type=float, default=0.35,
                    help="(openloop) per-session arrival rate, 1/s")
    ap.add_argument("--duration", type=float, default=2.0,
                    help="(openloop) arrival window, seconds")
    args = ap.parse_args()

    store = build_store()
    modes = ["sync", "isolated", "shared"] if args.mode == "all" \
        else [args.mode]
    if args.openloop:
        for mode in modes:
            rep = run_openloop(mode, args.sessions, args.rate,
                               args.duration, store=store)
            print(f"[openloop] mode={rep['mode']} sessions={rep['sessions']} "
                  f"offered={rep['offered_rate']:.0f}/s "
                  f"achieved={rep['achieved_rate']:.0f}/s "
                  f"p50={rep['p50_ms']:.1f}ms p99={rep['p99_ms']:.1f}ms "
                  f"max_inflight={rep['max_inflight_sessions']} "
                  f"errors={rep['errors']}")
        return
    specs = get_clients(args.clients, priority="high", ops=args.ops)
    specs += restore_clients(args.low_pri_restores)
    specs += multiget_clients(args.multigets)
    for mode in modes:
        _print_report(run_serving(mode, specs, store=store,
                                  remine=args.remine))


if __name__ == "__main__":
    main()
