"""Public Foreactor API (paper §5.1): graph registration, function wrapping,
and the POSIX-call interception layer.

Python offers no linker ``--wrap``/LD_PRELOAD, so we use the paper's stated
alternative ("developers could directly inject wrapper code in-place around
candidate functions", §5.4): application code performs I/O through the
``repro_torch.core.api.io`` module-level functions, and a registered function is
activated with ``Foreactor.wrap``.  While an activation is live on a thread,
every ``io.*`` call on that thread is intercepted by its ``SpecSession``;
otherwise calls go straight to the device.  Graph instances are per-thread
(paper: "every foreaction graph instance is per-thread local").

Backend selection is topology-aware: the default ``backend="auto"`` resolves
to per-device queue pairs (:class:`repro_torch.core.backends.MultiQueueBackend`)
when the device is a :class:`repro_torch.core.device.ShardedDevice`, and to the
single io_uring-style queue pair otherwise — existing call sites gain
multi-device fan-out transparently.

Concurrency model is opt-in per Foreactor: the default keeps one private
live queue pair per application thread (the paper's setup); ``shared=True``
instead multiplexes every concurrent session onto ONE backend through a
:class:`repro_torch.core.backends.SlotScheduler` — sessions carry a *tenant*
identity (``activate(tenant=...)``, the ``fa.tenant(...)`` thread context,
or the thread name) and lease submission slots weighted-fairly, so a
serving process with hundreds of clients does not need hundreds of worker
pools and no tenant's demand I/O waits behind another's speculation.

Cross-references: docs/ARCHITECTURE.md ("Public API") maps this module to
paper §5.1; docs/GLOSSARY.md defines the terms used here.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from .backends import (Backend, SharedBackend, SlotScheduler, SyncBackend,
                       make_backend, resolve_priority)
from .device import Device, OSDevice
from .engine import DepthController, SessionStats, SpecSession
from .graph import ForeactionGraph
from .plan import GraphPlan, compile_plan
from .plan import stats as plan_stats
from .syscalls import IOFuture, Sys
from .trace import RecordingSession, Trace, TraceRecorder, TraceRing

_tls = threading.local()


def _session_stack() -> List[SpecSession]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = []
        _tls.stack = st
    return st


def current_session() -> Optional[SpecSession]:
    st = _session_stack()
    return st[-1] if st else None


class Foreactor:
    """The libforeactor singleton-ish object: device + backend + registry."""

    def __init__(
        self,
        device: Optional[Device] = None,
        backend: str = "auto",
        depth: Union[int, str] = 8,
        workers: int = 16,
        strict: bool = False,
        depth_range: Tuple[int, int] = (1, 64),
        shared: bool = False,
        shared_slots: Optional[int] = None,
        staging: bool = True,
        trace_capacity: int = 64,
        coalesce: bool = False,
    ):
        if not (isinstance(depth, int) or depth == "adaptive"):
            raise ValueError(f"depth must be an int or 'adaptive', got {depth!r}")
        self.device = device if device is not None else OSDevice()
        self.backend_name = backend
        self.depth = depth
        self.depth_range = depth_range
        self.workers = workers
        self.strict = strict
        #: shared=True replaces the per-thread private queue pairs with ONE
        #: backend whose submission slots are leased to concurrent sessions
        #: through a SlotScheduler (multi-tenant serving mode).  shared_slots
        #: sets the scheduler's slot window independently of the worker
        #: count (slots above it queue as cancellable, evictable entries);
        #: default: one slot per worker.
        self.shared = shared
        self.shared_slots = shared_slots
        #: extent coalescing (repro_torch.core.coalesce): async backends fuse
        #: adjacent same-fd PREAD runs into MB-scale super-reads at
        #: dispatch.  Off by default — it changes the device-op profile
        #: (fewer, larger reads), which bandwidth-oriented workloads want
        #: and op-count-sensitive tests do not.
        self.coalesce = coalesce
        #: undoable write speculation (repro_torch.store.staging): sessions run
        #: tracked writes inside a staging transaction — speculative pwrites
        #: land in staging extents / carry undo bytes, creating opens get
        #: anonymous staged names, publish happens at close barriers or
        #: session commit, rollback on abort.  Requires device support
        #: (rename/unlink/truncate); silently off where unsupported.
        self.staging = staging and getattr(
            self.device, "supports_staging", lambda: False)()
        self._graphs: Dict[str, ForeactionGraph] = {}
        self._graph_builders: Dict[str, Callable[[], ForeactionGraph]] = {}
        #: plan-cache observability, per graph name: how many times plan()
        #: was probed, how many probes produced a new plan object (compile
        #: or first sight), and how many times the graph was (re)built — the
        #: version bumps when mine() replaces a registered graph, so serving
        #: stats can tell plan-cache thrash from healthy reuse
        self._plan_probes: Dict[str, int] = {}
        self._plan_builds: Dict[str, int] = {}
        # the last plan OBJECT seen per (name, mode) — identity, not id():
        # a recompiled plan can land at a freed predecessor's address
        self._plan_seen: Dict[Tuple[str, str], GraphPlan] = {}
        self._graph_versions: Dict[str, int] = {}
        #: hot-swap observability, per graph name: how many times a new
        #: builder replaced the registered one mid-flight (swap_graph) and
        #: how many of those were the rollback guard restoring the previous
        #: graph after a regression
        self._graph_swaps: Dict[str, int] = {}
        self._graph_rollbacks: Dict[str, int] = {}
        self._controllers: Dict[str, DepthController] = {}
        #: recorded traces, one bounded ring per endpoint — sampling must
        #: never grow memory without bound (every trace pins its raw I/O
        #: buffers); overflow evicts the oldest pair and is counted in
        #: trace_stats()
        self.trace_capacity = trace_capacity
        self._traces: Dict[str, TraceRing] = {}
        #: attached online re-miner (repro_torch.analysis.remine.ReMiner), or None
        self._reminer = None
        self.total_stats = SessionStats()
        self._backends: List[Backend] = []
        self._backend_pool = threading.local()  # one live queue pair per thread
        self._tenant_tls = threading.local()  # fa.tenant(...) context state
        self.scheduler: Optional[SlotScheduler] = None
        self._shared_inner: Optional[Backend] = None
        self._lock = threading.Lock()

    # -- registry ----------------------------------------------------------
    def register(self, name: str, builder: Callable[[], ForeactionGraph]) -> None:
        """Register a graph builder; built lazily on first activation
        (paper: 'invoked only once upon the first invocation of f')."""
        self._graph_builders[name] = builder

    def graph(self, name: str) -> ForeactionGraph:
        with self._lock:
            if name not in self._graphs:
                self._graphs[name] = self._graph_builders[name]()
                self._graph_versions[name] = \
                    self._graph_versions.get(name, 0) + 1
            return self._graphs[name]

    def invalidate_graph(self, name: str) -> None:
        """Drop the cached built graph so the next activation rebuilds it
        from the (possibly re-registered) builder — bumping the graph
        version ``plan_cache_stats`` reports.  ``mine()`` uses this when a
        mined graph replaces a registered one."""
        with self._lock:
            self._graphs.pop(name, None)

    def graph_version(self, name: str) -> int:
        """Times the graph under ``name`` has been built (bumps on the
        first build after registration, mine() re-registration, or a
        swap_graph hot-swap).  0 until the first activation builds it."""
        with self._lock:
            return self._graph_versions.get(name, 0)

    def swap_graph(self, name: str,
                   builder: Callable[[], ForeactionGraph],
                   rollback: bool = False) -> Optional[Callable[[], ForeactionGraph]]:
        """Atomically hot-swap the registered graph: replace the builder and
        drop the cached built graph in one critical section, so the next
        activation builds (and compiles) the new graph at version N+1 while
        every in-flight session keeps speculating on the plan object it
        activated with — plans are immutable and cached per graph *object*,
        so a swap can never mutate a live session's schedule.

        Returns the previous builder (the re-miner stashes it so its
        regression guard can roll back a swap whose waste ledger regresses;
        ``rollback=True`` marks this swap as such a restoration).  Counted
        per graph in :meth:`plan_cache_stats` (``swaps``/``rollbacks``)."""
        with self._lock:
            prev = self._graph_builders.get(name)
            self._graph_builders[name] = builder
            self._graphs.pop(name, None)  # next activation builds version N+1
            self._graph_swaps[name] = self._graph_swaps.get(name, 0) + 1
            if rollback:
                self._graph_rollbacks[name] = \
                    self._graph_rollbacks.get(name, 0) + 1
        return prev

    @property
    def reminer(self):
        """The attached online re-miner, or None."""
        return self._reminer

    def attach_reminer(self, reminer) -> None:
        """Attach an online re-miner (:class:`repro_torch.analysis.remine.ReMiner`
        does this in its constructor).  From then on ``activate`` asks it to
        elect sampled activations (which record a trace serially instead of
        speculating) and ``deactivate`` feeds it every finished session's
        stats for the per-version waste ledger its rollback guard watches."""
        self._reminer = reminer

    def _depth_mode(self, depth) -> str:
        return "adaptive" if depth == "adaptive" else "fixed"

    def plan(self, name: str, depth: Optional[Union[int, str]] = None) -> GraphPlan:
        """The compiled :class:`GraphPlan` for a registered graph — built
        (and the graph itself, if still lazy) on first use, then cached per
        ``(graph, depth-mode)`` so every activation pays one dict probe.
        Consumers with latency-critical first calls (checkpoint saves,
        serving warm-up) call this eagerly to move compilation off the
        measured path."""
        depth = self.depth if depth is None else depth
        mode = self._depth_mode(depth)
        p = compile_plan(self.graph(name), mode)
        with self._lock:
            self._plan_probes[name] = self._plan_probes.get(name, 0) + 1
            if self._plan_seen.get((name, mode)) is not p:
                self._plan_seen[(name, mode)] = p
                self._plan_builds[name] = self._plan_builds.get(name, 0) + 1
        return p

    def plan_cache_stats(self) -> Dict[str, Any]:
        """Plan-cache and graph-version observability, surfaced in serving
        summaries (``repro_torch.launch.ioserver``): per graph name, ``probes``
        (plan() calls), ``compiles`` (probes that produced a new plan
        object), ``hits`` (probes served by the cache), ``graph_version``
        (times the graph was built — bumps when a mined graph replaces a
        registered one), and ``swaps``/``rollbacks`` (hot-swaps applied by
        the online re-miner, and how many of those its regression guard
        reverted).  ``global`` mirrors the process-wide
        :data:`repro_torch.core.plan.stats` counters."""
        with self._lock:
            per = {}
            for name in set(self._plan_probes) | set(self._graph_swaps):
                probes = self._plan_probes.get(name, 0)
                builds = self._plan_builds.get(name, 0)
                per[name] = {
                    "probes": probes,
                    "compiles": builds,
                    "hits": probes - builds,
                    "graph_version": self._graph_versions.get(name, 0),
                    "swaps": self._graph_swaps.get(name, 0),
                    "rollbacks": self._graph_rollbacks.get(name, 0),
                }
            return {"per_graph": per, "global": dict(plan_stats)}

    def _make_backend(self) -> Backend:
        """Per-thread backend reuse: like the paper, each application thread
        keeps its own live io_uring queue pair across activations instead of
        paying setup cost per wrapped call."""
        b = getattr(self._backend_pool, "backend", None)
        if b is None:
            b = make_backend(self.backend_name, self.device,
                             workers=self.workers, coalesce=self.coalesce)
            self._backend_pool.backend = b
            with self._lock:
                self._backends.append(b)
        return b

    def shared_backend(self) -> Backend:
        """The one shared async backend (created lazily; ``shared=True``)."""
        with self._lock:
            if self._shared_inner is None:
                inner = make_backend(self.backend_name, self.device,
                                     workers=self.workers,
                                     coalesce=self.coalesce)
                if isinstance(inner, SyncBackend):
                    raise ValueError(
                        "shared=True needs an async backend (got 'sync')")
                self._shared_inner = inner
                self.scheduler = SlotScheduler(self.shared_slots
                                               or inner.capacity)
                self._backends.append(inner)
            return self._shared_inner

    @contextlib.contextmanager
    def tenant(self, name: str, weight: float = 1.0, priority="normal"):
        """Default tenant identity for activations made on this thread —
        how a serving client thread (or anything activating indirectly,
        e.g. through the checkpoint manager) states who it is and what its
        weight/priority class are, without threading kwargs through every
        call site."""
        prev = getattr(self._tenant_tls, "ident", None)
        self._tenant_tls.ident = (name, float(weight), priority)
        try:
            yield self
        finally:
            self._tenant_tls.ident = prev

    def _shared_view(self, tenant: Optional[str], weight: Optional[float],
                     priority) -> SharedBackend:
        inner = self.shared_backend()
        tls = getattr(self._tenant_tls, "ident", None)
        if tenant is None:
            # the TLS context's weight/priority belong to the TLS tenant —
            # they must never leak onto an explicitly named tenant
            tenant = tls[0] if tls else threading.current_thread().name
            if weight is None:
                weight = tls[1] if tls else None
            if priority is None:
                priority = tls[2] if tls else None
        return SharedBackend(inner, self.scheduler, tenant=tenant,
                             weight=1.0 if weight is None else weight,
                             priority=resolve_priority(
                                 "normal" if priority is None else priority))

    def controller(self, graph_name: str) -> DepthController:
        """The shared per-graph adaptive depth controller (created lazily);
        sessions of the same graph learn one depth together."""
        with self._lock:
            c = self._controllers.get(graph_name)
            if c is None:
                lo, hi = self.depth_range
                c = DepthController(min_depth=lo, max_depth=hi)
                self._controllers[graph_name] = c
            return c

    # -- activation ----------------------------------------------------------
    def activate(self, graph_name: str, ctx: Dict[str, Any],
                 depth: Optional[Union[int, str]] = None,
                 tenant: Optional[str] = None,
                 weight: Optional[float] = None,
                 priority=None) -> SpecSession:
        # trace sampling: an attached re-miner elects 1-in-N activations per
        # watched endpoint; those run serially under a RecordingSession (no
        # speculation — observation must not perturb the pattern) and
        # deliver their trace to the endpoint's bounded ring on clean finish
        rm = self._reminer
        if rm is not None and rm.sample(graph_name):
            rec = RecordingSession(self.device, graph_name, ctx,
                                   sink=self._deliver_trace)
            rec.graph_version = self.graph_version(graph_name)
            _session_stack().append(rec)
            return rec  # duck-types the SpecSession surface wrap/io touch
        depth = self.depth if depth is None else depth
        controller = None
        if depth == "adaptive":
            controller = self.controller(graph_name)
            depth = 0  # ignored: SpecSession.depth tracks the controller live
        if self.shared:
            backend: Backend = self._shared_view(tenant, weight, priority)
        else:
            backend = self._make_backend()
        graph = self.graph(graph_name)
        sess = SpecSession(
            graph=graph,
            ctx=ctx,
            backend=backend,
            device=self.device,
            depth=depth,
            strict=self.strict,
            controller=controller,
            tenant=tenant,
            staging=self.staging,
            plan=self.plan(graph_name,
                           "adaptive" if controller is not None else depth),
            graph_name=graph_name,
            graph_version=self.graph_version(graph_name),
        )
        _session_stack().append(sess)
        return sess

    def deactivate(self, sess: SpecSession) -> SessionStats:
        st = _session_stack()
        assert st and st[-1] is sess, "unbalanced session stack"
        st.pop()
        stats = sess.finish()  # cancels leftovers + drains; backend is reused
        if getattr(sess.backend, "is_view", False):
            sess.backend.shutdown()  # release the slot lease, keep the inner
        with self._lock:
            self.total_stats.merge(stats)
        rm = self._reminer
        if rm is not None and not getattr(sess, "is_recording", False):
            # per-version waste ledger for the rollback guard: attribute
            # this session's counters to the graph build it activated on
            rm.on_session_finish(getattr(sess, "graph_name", None),
                                 getattr(sess, "graph_version", 0), stats)
        return stats

    def wrap(self, graph_name: str,
             capture: Callable[..., Dict[str, Any]],
             auto_graph: bool = False,
             observe_calls: int = 2,
             tenant: Optional[Union[str, Callable[..., str]]] = None,
             weight: Optional[float] = None,
             priority=None) -> Callable:
        """Decorator: shadow function ``f`` with a wrapper that captures the
        Input annotation variables and runs ``f`` under a SpecSession.

        ``tenant``/``weight``/``priority`` set the activation's identity for
        the shared-backend scheduler (``shared=True``); ``tenant`` may be a
        callable over the wrapped function's arguments for per-call tenancy.
        Unset, they fall back to the thread's ``fa.tenant(...)`` context and
        then to the thread name.

        With ``auto_graph=True`` no registered graph is needed: the first
        ``observe_calls`` invocations run serially under a
        :class:`TraceRecorder`, then the traces are mined into a graph
        (:func:`repro_torch.analysis.mine.mine_and_validate`) and — if the mined
        graph replays every recorded trace exactly — registered and used for
        speculation from then on.  A function the miner cannot prove sound
        stays permanently serial (``wrapper.__foreactor_auto__['state']``
        reports ``'disabled'`` with the reason) rather than speculating on a
        wrong graph.
        """

        def _tenant_of(args, kwargs) -> Optional[str]:
            return tenant(*args, **kwargs) if callable(tenant) else tenant

        def deco(fn: Callable) -> Callable:
            if not auto_graph:
                @functools.wraps(fn)
                def wrapper(*args, **kwargs):
                    ctx = capture(*args, **kwargs)
                    sess = self.activate(graph_name, ctx,
                                         tenant=_tenant_of(args, kwargs),
                                         weight=weight, priority=priority)
                    try:
                        return fn(*args, **kwargs)
                    except BaseException:
                        # the staging transaction must roll back, not commit
                        sess.mark_failed()
                        raise
                    finally:
                        self.deactivate(sess)

                wrapper.__foreactor_graph__ = graph_name  # type: ignore[attr-defined]
                return wrapper

            state = {"state": "observing", "reason": None}
            state_lock = threading.Lock()

            @functools.wraps(fn)
            def auto_wrapper(*args, **kwargs):
                with state_lock:
                    mode = state["state"]
                if mode == "speculating":
                    ctx = capture(*args, **kwargs)
                    sess = self.activate(graph_name, ctx,
                                         tenant=_tenant_of(args, kwargs),
                                         weight=weight, priority=priority)
                    try:
                        return fn(*args, **kwargs)
                    except BaseException:
                        sess.mark_failed()
                        raise
                    finally:
                        self.deactivate(sess)
                if mode == "disabled":
                    return fn(*args, **kwargs)
                # observing: record one more trace, then try to mine
                ctx = capture(*args, **kwargs)
                out = self.record(graph_name, ctx, fn, *args, **kwargs)
                with state_lock:
                    if state["state"] == "observing" \
                            and len(self.traces(graph_name)) >= observe_calls:
                        try:
                            self.mine(graph_name)
                            state["state"] = "speculating"
                        except Exception as e:  # Unminable / Unsound
                            state["state"] = "disabled"
                            state["reason"] = str(e)
                return out

            auto_wrapper.__foreactor_graph__ = graph_name  # type: ignore[attr-defined]
            auto_wrapper.__foreactor_auto__ = state  # type: ignore[attr-defined]
            return auto_wrapper

        return deco

    # -- observe-then-speculate ----------------------------------------------
    def record(self, name: str, ctx: Dict[str, Any],
               fn: Callable, *args, **kwargs) -> Any:
        """Run ``fn`` once under a :class:`TraceRecorder` (serial, direct
        execution) and store the (ctx, trace) pair under ``name``."""
        rec = TraceRecorder(self.device, name=name)
        _session_stack().append(rec)
        try:
            out = fn(*args, **kwargs)
        finally:
            st = _session_stack()
            assert st and st[-1] is rec, "unbalanced recorder stack"
            st.pop()
        trace = rec.finish()
        self._deliver_trace(name, ctx, trace)
        return out

    def _deliver_trace(self, name: str, ctx: Dict[str, Any],
                       trace: Trace) -> None:
        """Store one recorded (ctx, trace) pair in the endpoint's bounded
        ring and tell the attached re-miner (if any) new evidence exists —
        its cadence counter decides whether a re-mine attempt runs now."""
        with self._lock:
            ring = self._traces.get(name)
            if ring is None:
                ring = self._traces[name] = TraceRing(self.trace_capacity)
            ring.append(dict(ctx), trace)
        rm = self._reminer
        if rm is not None:
            rm.on_trace(name)

    def observe(self, name: str,
                capture: Callable[..., Dict[str, Any]]) -> Callable:
        """Decorator: every invocation of the wrapped function is recorded
        as a trace under ``name`` (serial execution; see ``wrap(...,
        auto_graph=True)`` for the record→mine→speculate pipeline)."""

        def deco(fn: Callable) -> Callable:
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                ctx = capture(*args, **kwargs)
                return self.record(name, ctx, fn, *args, **kwargs)

            wrapper.__foreactor_observed__ = name  # type: ignore[attr-defined]
            return wrapper

        return deco

    def traces(self, name: str) -> List[Tuple[Dict[str, Any], Trace]]:
        with self._lock:
            ring = self._traces.get(name)
            return ring.snapshot() if ring is not None else []

    def trace_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-endpoint trace-ring occupancy and drop counts
        (:meth:`repro_torch.core.trace.TraceRing.stats`): sustained sampling is
        memory-bounded by design, and nonzero ``dropped`` means traces are
        arriving faster than the re-mine cadence consumes them."""
        with self._lock:
            return {name: ring.stats() for name, ring in self._traces.items()}

    def drop_traces(self, name: str) -> None:
        """Release every recorded trace under ``name`` (the re-miner calls
        this after a hot-swap or rollback: evidence of the old pattern must
        not contaminate the next mining attempt)."""
        with self._lock:
            self._traces.pop(name, None)

    def mine(self, name: str, register: bool = True, holdout: bool = True):
        """Mine the traces recorded under ``name`` into a validated
        ``ForeactionGraph`` and (by default) register it under the same
        name.  Raises ``UnminableTrace``/``UnsoundGraph`` on refusal.

        On successful registration the recorded traces are released — the
        raw I/O buffers they hold (every pread result) must not stay
        resident for the Foreactor's lifetime once the graph exists.
        """
        from repro_torch.analysis.mine import mine_and_validate  # lazy: no cycle

        pairs = self.traces(name)
        if not pairs:
            raise ValueError(f"no traces recorded under {name!r}")
        ctxs = [c for (c, _t) in pairs]
        trs = [t for (_c, t) in pairs]
        mined = mine_and_validate(trs, ctxs, name=name, holdout=holdout)
        if register:
            with self._lock:
                self._graph_builders[name] = mined.builder()
                self._graphs.pop(name, None)  # rebuild on next activation
                self._traces.pop(name, None)
        return mined

    def shutdown(self) -> None:
        with self._lock:
            backends, self._backends = self._backends, []
        for b in backends:
            b.shutdown()


class _PassthroughForeactor(Foreactor):
    """A disabled Foreactor: wrap() runs the function unmodified (baseline)."""

    def activate(self, graph_name, ctx, depth=None, **kw):  # type: ignore[override]
        sess = SpecSession(self.graph(graph_name), ctx, SyncBackend(self.device),
                           self.device, depth=0, strict=False)
        # depth=0 sync-backend session == original serial execution
        _session_stack().append(sess)
        return sess


def make_foreactor(enabled: bool = True, **kw) -> Foreactor:
    return Foreactor(**kw) if enabled else _PassthroughForeactor(**kw)


# ---------------------------------------------------------------------------
# The interception layer: application code calls these.  With an active
# session whose device matches, calls are routed through the pre-issuing
# engine; otherwise they hit the device directly.
# ---------------------------------------------------------------------------
class io:
    @staticmethod
    def _route(device: Device, sc: Sys, args: tuple) -> Any:
        sess = current_session()
        if sess is not None and sess.device is device:
            return sess.intercept(sc, args)
        return _direct(device, sc, args)

    @staticmethod
    def _route_async(device: Device, sc: Sys, args: tuple) -> IOFuture:
        """Futures-style routing: with an active matching session the call
        becomes a harvestable ledger entry whose ``result()`` is a late
        demand point; otherwise (no session, or a TraceRecorder that must
        observe serial order) it executes now and the future is returned
        already resolved — so code written against the async API behaves
        identically with speculation off."""
        sess = current_session()
        if sess is not None and sess.device is device:
            ia = getattr(sess, "intercept_async", None)
            if ia is not None:
                return ia(sc, args)
            return IOFuture.resolved(sess.intercept(sc, args))
        return IOFuture.resolved(_direct(device, sc, args))

    @staticmethod
    def open(device: Device, path: str, flags: str = "r") -> int:
        return io._route(device, Sys.OPEN, (path, flags))

    @staticmethod
    def close(device: Device, fd: int) -> None:
        return io._route(device, Sys.CLOSE, (fd,))

    @staticmethod
    def pread(device: Device, fd: int, size: int, offset: int) -> bytes:
        return io._route(device, Sys.PREAD, (fd, size, offset))

    @staticmethod
    def pwrite(device: Device, fd: int, data: bytes, offset: int) -> int:
        return io._route(device, Sys.PWRITE, (fd, data, offset))

    @staticmethod
    def fstatat(device: Device, path: str):
        return io._route(device, Sys.FSTATAT, (path,))

    @staticmethod
    def getdents(device: Device, path: str) -> list:
        return io._route(device, Sys.GETDENTS, (path,))

    @staticmethod
    def fsync(device: Device, fd: int) -> None:
        return io._route(device, Sys.FSYNC, (fd,))

    # -- futures-style variants (late demand; see engine.intercept_async) --
    @staticmethod
    def pread_async(device: Device, fd: int, size: int,
                    offset: int) -> IOFuture:
        return io._route_async(device, Sys.PREAD, (fd, size, offset))

    @staticmethod
    def pwrite_async(device: Device, fd: int, data: bytes,
                     offset: int) -> IOFuture:
        """Futures-style write: inside a session running a staging
        transaction the pwrite becomes a harvestable (speculable, undoable)
        ledger entry and ``result()`` is the late demand point returning the
        byte count; without staging — or with no session — it degrades to
        the blocking write, already resolved."""
        return io._route_async(device, Sys.PWRITE, (fd, data, offset))

    @staticmethod
    def open_async(device: Device, path: str, flags: str = "r") -> IOFuture:
        return io._route_async(device, Sys.OPEN, (path, flags))

    @staticmethod
    def fstatat_async(device: Device, path: str) -> IOFuture:
        return io._route_async(device, Sys.FSTATAT, (path,))

    @staticmethod
    def rename(device: Device, src: str, dst: str) -> None:
        return io._route(device, Sys.RENAME, (src, dst))

    @staticmethod
    def unlink(device: Device, path: str) -> None:
        return io._route(device, Sys.UNLINK, (path,))


def _direct(device: Device, sc: Sys, args: tuple) -> Any:
    from .syscalls import execute

    device.charge_crossing()
    return execute(device, sc, args)
