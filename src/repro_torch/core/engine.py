"""The pre-issuing engine (paper §5.2, Algorithm 1) and per-invocation
speculation sessions.

A ``SpecSession`` is the per-thread, per-invocation instance of a foreaction
graph.  Every intercepted I/O call:

1. peeks up to ``depth`` successor nodes in execution order, computing
   argument values explicitly and *preparing* every node that is safe —
   pure nodes always, non-pure nodes only when no weak edge lies on the
   path from the frontier (paper §3.3: no unrecoverable side effects);
2. submits all prepared entries as one batch to the backend;
3. serves the frontier itself — harvesting the async completion if it was
   pre-issued, else invoking it synchronously — and runs its SaveResult
   stub exactly once;
4. advances the frontier.

On function exit, remaining speculative requests are cancelled and the
backend drained (the cancellation overhead of paper Fig. 10).

The session never walks the authoring-layer object graph: it interprets the
graph's *compiled plan* (:mod:`repro_torch.core.plan`) — flat node records indexed
by integer id — with integer cursors, and it accumulates the peeked batch
locally, handing it to the backend in one ``submit`` call.  Two consequences
the old object walker could not offer:

* peek cost no longer scales with graph-authoring style — the sliding peek
  window survives weak edges as long as the window's prefix stays fully
  issued (an all-pure mined chain re-walks nothing), falling back to the
  paper's exact from-the-frontier walk only when a non-pure node was
  actually deferred by a conservatively stale weak flag, which keeps the
  pre-issue schedule identical to the original algorithm;
* the submission path costs one lock acquisition per batch instead of one
  per request (the Python mirror of "one io_uring_enter per batch").

The engine is backend-agnostic: a batch submitted through
:class:`repro_torch.core.backends.MultiQueueBackend` fans out across the lanes of
a sharded device with no change here — routing is an I/O-plane/device
concern, Algorithm 1 only ever sees submit/wait.

Cross-references: docs/ARCHITECTURE.md ("Pre-issuing engine", "Plan
compilation & the unified I/O plane") maps this module to paper §5.2;
*frontier*, *epoch vector*, *pre-issue*, *graph plan* and friends are
defined in docs/GLOSSARY.md.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .backends import Backend
from .device import Device
from .graph import ForeactionGraph, FromNode
from .plan import END, KIND_BRANCH, KIND_SYSCALL, GraphPlan, compile_plan
from .syscalls import (Effect, FromRequest, IOFuture, IORequest, ReqState,
                       Sys, effect_of, execute)


class FuturePoisoned(RuntimeError):
    """``IOFuture.result()`` on a future whose session failed
    (:meth:`SpecSession.mark_failed`) before the future resolved — the
    speculated bytes must never be trusted."""


class DepthController:
    """Online speculation-depth tuning (replaces a hand-picked fixed depth).

    The paper fixes ``depth`` per workload; Fig. 10 shows why no single
    value wins — too shallow leaves the device idle (the frontier blocks on
    requests issued moments earlier), too deep pays cancellation/wasted-
    completion overhead on early exits and drain time at teardown.  The
    controller learns the workload's shape from two cheap signals:

    * **wait fraction** — time the frontier spends blocked in ``wait()``
      relative to wall time.  High wait with no waste means requests were
      issued too late: grow (multiplicative).
    * **wasted work** — cancelled + wasted completions at session teardown.
      Waste above ``waste_tolerance`` × harvested means speculation ran past
      the function's real exit: shrink the depth to just past the observed
      consumption (``served_async + 1``).

    Growth is additionally gated on *backend queue occupancy*: when the
    backend already has ``capacity`` requests in flight, more depth only
    queues entries behind busy workers, so the controller stops growing
    there (paper Fig. 10's submission-cost plateau).

    One controller is shared by every session of a graph (per
    ``Foreactor``), so short repeated invocations converge across calls
    while a single long loop converges within one session via the
    window-based wait signal.  Thread-safe; decisions are coarse on purpose
    — the cost of being one step off is tiny next to device latency.
    """

    def __init__(
        self,
        initial: int = 2,
        min_depth: int = 1,
        max_depth: int = 64,
        window: int = 8,
        waste_tolerance: float = 0.25,
        wait_threshold: float = 0.05,
    ):
        self.min_depth = max(1, min_depth)
        self.max_depth = max(self.min_depth, max_depth)
        self._depth = min(self.max_depth, max(self.min_depth, initial))
        self.window = max(2, window)
        self.waste_tolerance = waste_tolerance
        self.wait_threshold = wait_threshold
        self._lock = threading.Lock()
        # intra-session window accumulators
        self._win_serves = 0
        self._win_wait = 0.0
        self._win_t0: Optional[float] = None
        # last finished session's waste verdict (gates growth)
        self._last_wasteful = False
        self.grows = 0
        self.shrinks = 0

    @property
    def depth(self) -> int:
        return self._depth

    def _grow(self, backend: Optional[Backend]) -> None:
        if self._last_wasteful:
            return  # the workload exits early; deeper only wastes more
        if backend is not None:
            cap = backend.capacity
            if cap and backend.inflight() >= cap and self._depth >= cap:
                return  # queue already saturated: depth buys nothing
        new = min(self.max_depth, self._depth * 2)
        if new != self._depth:
            self._depth = new
            self.grows += 1

    def on_serve(self, wait_seconds: float, async_hit: bool,
                 backend: Optional[Backend] = None) -> None:
        """Per-intercept signal: how long the frontier blocked."""
        now = time.perf_counter()
        with self._lock:
            if self._win_t0 is None:
                self._win_t0 = now
                return  # the first serve of a window only starts the clock
            self._win_serves += 1
            self._win_wait += wait_seconds
            if self._win_serves >= self.window:
                elapsed = max(now - self._win_t0, 1e-9)
                if self._win_wait > self.wait_threshold * elapsed:
                    self._grow(backend)
                self._win_serves = 0
                self._win_wait = 0.0
                self._win_t0 = now

    def on_finish(self, stats: "SessionStats", wall_seconds: float,
                  backend: Optional[Backend] = None) -> None:
        """Session-teardown signal: wasted vs harvested speculation."""
        with self._lock:
            self._win_serves = 0
            self._win_wait = 0.0
            self._win_t0 = None
            waste = stats.cancelled + stats.wasted_completions
            useful = stats.served_async
            if stats.pre_issued > 0 and waste > self.waste_tolerance * max(1, useful):
                target = max(self.min_depth, useful + 1)
                if target < self._depth:
                    self._depth = target
                    self.shrinks += 1
                self._last_wasteful = True
                return
            # hysteresis: one clean session must pass after a wasteful one
            # before growth resumes (prevents grow/shrink oscillation on
            # early-exit workloads)
            prev_wasteful = self._last_wasteful
            self._last_wasteful = False
            wall = max(wall_seconds, 1e-9)
            if not prev_wasteful and stats.intercepted >= 2 and \
                    stats.wait_seconds + stats.sync_seconds > self.wait_threshold * wall:
                self._grow(backend)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"depth": self._depth, "grows": self.grows,
                    "shrinks": self.shrinks}


@dataclass
class NodeState:
    issued: bool = False
    req: Optional[IORequest] = None
    harvested: bool = False
    #: the pre-issued request's arguments did not match what the
    #: application actually asked for (the live pattern drifted away from
    #: the graph) — its completion must be accounted as wasted, never
    #: harvested
    stale: bool = False


def _spec_args_match(spec_args: Tuple[Any, ...],
                     args: Tuple[Any, ...]) -> bool:
    """Harvest-time argument guard: may a pre-issued request's result be
    served for this intercepted call?

    The frontier is resolved by syscall *kind*; under pattern drift (a
    stale mined graph after an LSM compaction changed the level geometry)
    the kinds can still line up while the graph-computed arguments — fd,
    offset, size, path — point at yesterday's layout.  Harvesting such a
    request would silently return the wrong bytes, so the engine compares
    arguments before trusting a speculated completion and falls back to
    synchronous service on mismatch (the stale request is accounted as
    wasted/cancelled at finish, keeping the ledger invariant).

    Positions holding :class:`FromRequest` link placeholders are skipped —
    the producer's buffer *is* the argument, there is no application value
    to compare — as are raw write payloads (``bytes``/``bytearray``/
    ``memoryview``), where an O(n) memcmp per intercept would tax every
    staged write to defend against a drift mode the fd/offset check
    already catches."""
    if len(spec_args) != len(args):
        return False
    for a, b in zip(spec_args, args):
        if isinstance(a, (FromRequest, bytes, bytearray, memoryview)) \
                or isinstance(b, (bytes, bytearray, memoryview)):
            continue
        if a != b:
            return False
    return True


@dataclass
class SessionStats:
    intercepted: int = 0
    untracked: int = 0
    pre_issued: int = 0
    submits: int = 0  # non-empty submitted batches (queue-pair crossings)
    served_async: int = 0
    served_sync: int = 0
    cancelled: int = 0
    wasted_completions: int = 0
    #: pre-issued requests rejected by the harvest-time argument guard —
    #: the graph computed different arguments than the application issued
    #: (stale mined graph under pattern drift); served synchronously instead
    stale_harvests: int = 0
    #: async intercepts that handed back an unresolved IOFuture (the
    #: late-demand entries of the ledger)
    futures_issued: int = 0
    #: futures still unresolved when finish() ran — drained-then-materialized
    #: (clean exit) or poisoned (failed session)
    futures_drained: int = 0
    peek_seconds: float = 0.0
    wait_seconds: float = 0.0
    sync_seconds: float = 0.0
    harvest_seconds: float = 0.0

    def merge(self, other: "SessionStats") -> None:
        for f in (
            "intercepted", "untracked", "pre_issued", "submits", "served_async",
            "served_sync", "cancelled", "wasted_completions", "stale_harvests",
            "futures_issued", "futures_drained",
        ):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        for f in ("peek_seconds", "wait_seconds", "sync_seconds", "harvest_seconds"):
            setattr(self, f, getattr(self, f) + getattr(other, f))


class GraphMismatch(RuntimeError):
    """The intercepted syscall does not match the foreaction graph."""


class SpecSession:
    """One activation of a registered function on one thread.

    The session interprets the graph's compiled :class:`GraphPlan`: cursors
    are ``(node id, epoch vector)`` integer/tuple pairs, per-node dynamic
    state is keyed by them, and Algorithm 1's peek walks the plan's flat
    arrays.  The authoring-layer graph object is kept only for
    introspection (``sess.graph``).
    """

    def __init__(
        self,
        graph: ForeactionGraph,
        ctx: Dict[str, Any],
        backend: Backend,
        device: Device,
        depth: int = 8,
        strict: bool = True,
        controller: Optional[DepthController] = None,
        tenant: Optional[str] = None,
        staging: bool = False,
        plan: Optional[GraphPlan] = None,
        graph_name: Optional[str] = None,
        graph_version: int = 0,
    ):
        self.graph = graph
        #: registry identity, stamped by Foreactor.activate: which endpoint
        #: this session serves and which build of its graph it started on.
        #: A hot-swap mid-session never retargets a live session — it keeps
        #: speculating on the plan it activated with, and the version lets
        #: the re-miner's rollback guard attribute its waste ledger to the
        #: right graph build.
        self.graph_name = graph_name if graph_name is not None else graph.name
        self.graph_version = graph_version
        self.plan = plan if plan is not None else compile_plan(
            graph, "adaptive" if controller is not None else "fixed")
        self.ctx = ctx
        self.backend = backend
        self.device = device
        # tenant identity: who this activation speculates on behalf of (the
        # shared-backend scheduler arbitrates slots between tenants); private
        # backends leave it None.
        self.tenant = tenant if tenant is not None \
            else getattr(backend, "tenant", None)
        self._fixed_depth = depth
        self.controller = controller
        self.strict = strict
        self.stats = SessionStats()
        self._t0 = time.perf_counter()
        #: dynamic node state, keyed by (node id, epoch vector)
        self._state: Dict[Tuple[int, Tuple[int, ...]], NodeState] = {}
        #: the frontier cursor, possibly resting on a branch record
        self._cur: Tuple[int, Tuple[int, ...]] = (
            self.plan.start_dst, self.plan.initial_epochs())
        #: the branch-resolved syscall record intercept() is serving now
        #: (peek skips it: pre-issuing it would buy no overlap)
        self._frontier: Tuple[int, Tuple[int, ...]] = (END, ())
        # sliding peek window: resume point past the contiguous issued
        # prefix as (node id, epochs, conservative weak flag), and its
        # distance (in syscall records) from the current frontier
        self._peek: Optional[Tuple[int, Tuple[int, ...], bool]] = None
        self._peek_dist = 0
        #: peeked requests a mid-walk stub error kept from being submitted;
        #: finish() cancels them so the ledger invariant still holds
        self._orphans: List[IORequest] = []
        #: unresolved IOFutures handed out by intercept_async; finish()
        #: drains-then-materializes them (or poisons them on failure)
        self._futures: List[IOFuture] = []
        self._finished = False
        # undoable write speculation: when enabled, every tracked UNDOABLE
        # syscall — pre-issued or frontier-served — runs inside one staging
        # transaction (repro_torch.store.staging), committed on clean exit and
        # rolled back on failure.  The txn is created lazily on first use.
        self._staging_enabled = staging
        self.staging = None  # Optional[StagingTxn]
        self._failed = False

    def mark_failed(self) -> None:
        """The wrapped function raised: the session's staging transaction
        must roll back instead of committing (called by ``Foreactor.wrap``
        before ``deactivate`` runs in its ``finally``)."""
        self._failed = True

    def _txn(self):
        if self.staging is None and self._staging_enabled:
            from repro_torch.store.staging import StagingTxn  # lazy: no cycle
            self.staging = StagingTxn(self.device)
        return self.staging

    @property
    def depth(self) -> int:
        """Current speculation depth — fixed, or the adaptive controller's
        live value (re-read at every peek, so depth changes mid-session) —
        capped by the backend's speculation-budget lease: on a shared
        backend a session never peeks past its tenant's fair share of the
        queue, so depth tuning and slot arbitration cannot fight."""
        d = self.controller.depth if self.controller is not None \
            else self._fixed_depth
        lease = self.backend.spec_budget()
        return d if lease is None else min(d, lease)

    # -- Algorithm 1, over the compiled plan ---------------------------------
    def _peek_and_preissue(self) -> None:
        """Peek up to ``depth`` records beyond the frontier; prepare the
        safe ones; hand the batch to the backend in one ``submit`` call
        (one lock acquisition, one crossing on the queue-pair lane).

        The peek window *slides*: once every record between the frontier
        and the resume cursor is issued, the next peek continues from the
        cursor instead of re-walking the whole window — amortized O(1) per
        intercept regardless of authoring style, weak edges included (the
        cursor's stored weak flag is conservative relative to the advanced
        frontier, which can never unsoundly issue a non-pure record).  Only
        when that conservatism actually deferred one — ``_walk_window``
        reports it — does the peek fall back to the paper's exact walk from
        the frontier, so the pre-issue schedule is identical to the
        original object walker's."""
        t0 = time.perf_counter()
        batch: List[IORequest] = []
        ok = False
        try:
            # re-offer entries a mid-walk stub error stranded earlier: the
            # function kept running (it issued this very intercept), so they
            # are "guaranteed to happen" again — the object walker left them
            # in the backend SQ for the next flush for the same reason, and
            # without this a frontier demanding one would wait forever on a
            # request no worker ever received.
            if self._orphans:
                batch.extend(self._orphans)
                self._orphans.clear()
            depth = self.depth
            resume = self._peek
            if resume is not None:
                if self._walk_window(resume[0], resume[1], resume[2],
                                     self._peek_dist, depth, batch):
                    # stale-weak fallback: exact re-walk from the frontier
                    self._peek = None
                    fnid, fep = self._frontier
                    nid, ep, weak = self.plan.follow_out(fnid, fep)
                    self._walk_window(nid, ep, weak, 0, depth, batch)
            else:
                fnid, fep = self._frontier
                nid, ep, weak = self.plan.follow_out(fnid, fep)
                self._walk_window(nid, ep, weak, 0, depth, batch)
            ok = True
        finally:
            if batch:
                if ok:
                    # only a completed walk submits: if a stub raised
                    # mid-batch the accumulated entries are quarantined and
                    # finish() cancels them before they ever execute — a
                    # non-pure request is only "guaranteed to happen" while
                    # the function keeps running.
                    if self.backend.submit(batch):
                        self.stats.submits += 1
                else:
                    self._orphans.extend(batch)
            self.stats.peek_seconds += time.perf_counter() - t0

    def _walk_window(self, nid: int, ep: Tuple[int, ...], weak: bool,
                     dist: int, depth: int,
                     batch: List[IORequest]) -> bool:
        """One pass of the peek window over the plan arrays, appending every
        safely issuable record to ``batch``.  Returns True iff a non-pure
        record was deferred *because of* the walk's weak flag — the caller's
        cue that a conservatively stale resume cursor may have deferred
        something the exact walk would issue."""
        p = self.plan
        kind = p.kind
        choose = p.choose
        child_off = p.child_off
        edge_dst = p.edge_dst
        edge_weak = p.edge_weak
        edge_loop = p.edge_loop
        out_dst = p.out_dst
        out_weak = p.out_weak
        out_loop = p.out_loop
        compute = p.compute
        state = self._state
        ctx = self.ctx
        fnid, fep = self._frontier
        prefix = True  # still walking the contiguous issued prefix
        weak_deferral = False
        while dist < depth and nid != END:
            # resolve branch records until a syscall record (or End)
            while nid != END and kind[nid] == KIND_BRANCH:
                idx = choose[nid](ctx, ep)
                if idx is None:  # branch decision not ready: stop peeking
                    return weak_deferral
                e = child_off[nid] + idx
                lid = edge_loop[e]
                if lid >= 0:
                    ep = ep[:lid] + (ep[lid] + 1,) + ep[lid + 1:]
                if edge_weak[e]:
                    weak = True
                nid = edge_dst[e]
            if nid == END:
                return weak_deferral
            key = (nid, ep)
            st = state.get(key)
            if st is None:
                st = NodeState()
                state[key] = st
            if nid == fnid and ep == fep:
                # the resume cursor caught up with the frontier: intercept()
                # is serving this record right now — pre-issuing it here
                # would buy no overlap and cost an extra crossing + worker
                # handoff
                pass
            elif not st.issued:
                out = compute[nid](ctx, ep)
                if out is not None:
                    args, link = out
                    args = self._bind_deferred(args, ep)
                    if args is not None:
                        req = self._make_request(nid, args, link, ep, weak)
                        if req is not None:
                            st.issued = True
                            st.req = req
                            self.stats.pre_issued += 1
                            batch.append(req)
                        elif weak:
                            # the effect gate said no and the weak flag was
                            # the reason — possibly conservatively
                            weak_deferral = True
                if not st.issued:
                    prefix = False  # retry this record on the next peek
            # advance across the syscall record's out edge
            lid = out_loop[nid]
            if lid >= 0:
                ep = ep[:lid] + (ep[lid] + 1,) + ep[lid + 1:]
            if out_weak[nid]:
                weak = True
            nid = out_dst[nid]
            dist += 1
            if prefix:
                self._peek = (nid, ep, weak)
                self._peek_dist = dist
        return weak_deferral

    def _make_request(self, nid: int, args, link: bool,
                      epochs: Tuple[int, ...],
                      weak_crossed: bool) -> Optional[IORequest]:
        """Build the IORequest for a peeked record, or None if its effect
        class forbids pre-issuing here (paper §3.3, extended):

        * PURE — always pre-issuable, unchanged.
        * UNDOABLE — with staging on, always pre-issuable: creates are
          redirected to a staging extent, overwrites capture undo bytes
          (writes to files this txn created need neither).  Without
          staging, only when guaranteed (no weak edge crossed) — the
          paper's original rule.
        * BARRIER — only when guaranteed; a barrier can never run ahead of
          an exit that might abandon it.

        The effect class is read from the plan when statically known
        (everything but OPEN) — no per-peek classification call.
        """
        p = self.plan
        sc = p.sc[nid]
        tag = (nid, epochs)
        eff = p.effect[nid]
        if eff is None:
            eff = effect_of(sc, args)
        if eff is Effect.PURE:
            return IORequest(sc=sc, args=args, link=link, tag=tag)
        if eff is Effect.UNDOABLE and self._staging_enabled:
            txn = self._txn()
            if sc is Sys.OPEN:
                runner, rec = txn.stage_create(
                    args[0], args[1] if len(args) > 1 else "w")
                return IORequest(sc=sc, args=args, link=link, tag=tag,
                                 runner=runner, stage=rec)
            if sc is Sys.RENAME:
                runner, rec = txn.stage_rename(args)
                return IORequest(sc=sc, args=args, link=link, tag=tag,
                                 runner=runner, stage=rec)
            # PWRITE into a file this transaction created: on a guaranteed
            # path it needs no undo record (rollback unlinks the file).
            # Behind a weak edge it must NOT pre-issue at all — if the
            # create publishes (its open was demanded) the file's bytes
            # commit wholesale, and a byte-range undo of the un-demanded
            # writes is unsound under concurrency (interleaved extends make
            # old-bytes + truncate replay order-dependent).  The create
            # itself still speculates; its writes wait for the frontier.
            if self._fd_is_staged(txn, args[0]):
                if weak_crossed:
                    return None
                return IORequest(sc=sc, args=args, link=link, tag=tag)
            runner, rec = txn.stage_overwrite(args)
            return IORequest(sc=sc, args=args, link=link, tag=tag,
                             runner=runner, stage=rec)
        if not weak_crossed:  # guaranteed: UNDOABLE-unstaged and BARRIER
            req = IORequest(sc=sc, args=args, link=link, tag=tag)
            if sc is Sys.CLOSE:
                # bind the publish barrier to its record NOW, while the fd
                # is still open; the worker may execute this close (and the
                # OS recycle the fd number) long before the frontier serves
                # it, making fd-keyed lookup at harvest time unsound
                req.barrier_for = self._close_barrier_rec(args[0])
            return req
        return None

    def _close_barrier_rec(self, fd_arg):
        """The staged-create record a CLOSE's fd refers to, or None."""
        if self.staging is None:
            return None
        if isinstance(fd_arg, FromRequest):
            rec = fd_arg.req.stage
            return rec if rec is not None and rec.kind == "create" else None
        if isinstance(fd_arg, int):
            return self.staging.record_for_fd(fd_arg)
        return None

    @staticmethod
    def _fd_is_staged(txn, fd_arg) -> bool:
        if isinstance(fd_arg, FromRequest):
            rec = fd_arg.req.stage
            return rec is not None and rec.kind == "create"
        return isinstance(fd_arg, int) and txn.is_staged_fd(fd_arg)

    def _bind_deferred(self, args, epochs):
        """Rewrite FromNode placeholders to the producer's request at the
        same epoch; None if a producer has not been pre-issued (not ready)."""
        if not any(isinstance(a, FromNode) for a in args):
            return args
        id_of = self.plan.id_of
        bound = []
        for a in args:
            if isinstance(a, FromNode):
                pid = id_of.get(a.name)
                st = self._state.get((pid, epochs)) if pid is not None else None
                if st is None or st.req is None:
                    return None
                bound.append(FromRequest(st.req))
            else:
                bound.append(a)
        return tuple(bound)

    def intercept(self, sc: Sys, args: Tuple[Any, ...]) -> Any:
        """Entry point for every I/O call made while this session is active."""
        if self._finished:
            return self._exec_untracked(sc, args)
        self.stats.intercepted += 1
        # resolve the frontier: real execution has passed any branch points,
        # so their Choice stubs must now be decidable.
        p = self.plan
        nid, ep = self._cur
        res = p.resolve_branches(nid, ep, self.ctx, False)
        if res is None or res[0] == END or p.sc[res[0]] is not sc:
            # Syscall not described by the graph (e.g. the omitted rare
            # `open` branch in the paper's LSM graph): pass through.
            if self.strict and res is not None and res[0] != END \
                    and p.sc[res[0]] is not sc:
                raise GraphMismatch(
                    f"graph {self.plan.name!r}: expected {p.sc[res[0]]} at "
                    f"node {p.names[res[0]]!r}, application issued {sc}"
                )
            return self._exec_untracked(sc, args)
        fnid, fep = res[0], res[1]
        self._cur = (fnid, fep)
        self._frontier = (fnid, fep)

        # 1-2. peek + batch submit (overlaps with serving the frontier below)
        self._peek_and_preissue()

        # 3. serve the frontier
        key = (fnid, fep)
        st = self._state.get(key)
        if st is None:
            st = NodeState()
            self._state[key] = st
        # harvestable: a live pre-issued request exists AND the harvest-time
        # argument guard agrees it answers the call the application actually
        # made — under pattern drift (stale mined graph) the kinds match but
        # the graph-computed fd/offset/size point at yesterday's layout, and
        # harvesting would silently serve the wrong bytes
        harvestable = st.issued and st.req is not None \
            and st.req.state is not ReqState.CANCELLED
        if harvestable and not st.harvested \
                and not _spec_args_match(st.req.args, args):
            harvestable = False
            st.stale = True
            self.stats.stale_harvests += 1
        # resolve a close's publish-barrier record BEFORE serving: for a
        # pre-issued close it was bound at pre-issue; for a sync serve the
        # fd is still open right now.  After the close executes, the OS may
        # recycle the fd number onto a newer staged create.
        close_rec = None
        if sc is Sys.CLOSE and self.staging is not None:
            if harvestable:
                close_rec = st.req.barrier_for
            else:
                close_rec = self.staging.record_for_fd(args[0])
        if harvestable:
            t0 = time.perf_counter()
            self.backend.wait(st.req)
            blocked = time.perf_counter() - t0
            self.stats.wait_seconds += blocked
            self.stats.served_async += 1
            served_async = True
            if st.req.stage is not None:
                # the frontier reached a staged side effect: real execution
                # now depends on it — eligible for publish at its barrier
                self.staging.on_demand(st.req.stage)
            # materialize the result out of the internal buffer (paper
            # Fig. 10 'result copy') — for a leased read this is the one
            # bounded memcpy out of the registered buffer.
            t0 = time.perf_counter()
            result = st.req.take_result()
            self.stats.harvest_seconds += time.perf_counter() - t0
        else:
            t0 = time.perf_counter()
            # demand I/O about to run synchronously: let a shared backend
            # shed speculative queue pressure first (no-op on private ones)
            self.backend.note_demand()
            self.device.charge_crossing()
            result = self._serve_sync(sc, args)
            blocked = time.perf_counter() - t0
            self.stats.sync_seconds += blocked
            self.stats.served_sync += 1
            served_async = False
            st.issued = True
        if close_rec is not None:
            # publish barrier: closing a staged file commits it (rename)
            self.staging.publish_close(close_rec)
        if self.controller is not None:
            self.controller.on_serve(blocked, served_async, self.backend)
        save = p.save[fnid]
        if save is not None and not st.harvested:
            save(self.ctx, fep, result)
        st.harvested = True

        # 4. advance the frontier (the peek window's origin moves with it)
        lid = p.out_loop[fnid]
        if lid >= 0:
            fep = fep[:lid] + (fep[lid] + 1,) + fep[lid + 1:]
        self._cur = (p.out_dst[fnid], fep)
        if self._peek_dist > 0:
            self._peek_dist -= 1
        return result

    def intercept_async(self, sc: Sys, args: Tuple[Any, ...]) -> IOFuture:
        """Futures-style entry point: like :meth:`intercept`, but instead of
        blocking at the frontier it hands back an :class:`IOFuture` whose
        ``result()`` is the *late demand point*.

        The future is a harvestable ledger entry: its request may already be
        in flight via speculation (pre-issued by an earlier peek), or is
        demand-issued here — either way it rides the same node-state ledger
        and the same ``pre_issued == served_async + cancelled +
        wasted_completions`` accounting as a blocking intercept.  Compute
        between issue and ``result()`` overlaps with the I/O, with zero new
        threads.

        PURE calls always defer.  A PWRITE defers too when the session runs
        a staging transaction — the write is undoable there (staged extent
        or undo bytes), so its completion can be demanded late exactly like
        a read's; ``result()`` returns the byte count.  Everything else
        (close, fsync, unstaged writes) is an ordering point the frontier
        must serve in place, so it takes the blocking path and returns an
        already-resolved future.
        """
        if self._finished:
            return IOFuture.resolved(self._exec_untracked(sc, args))
        eff = effect_of(sc, args)
        if eff is not Effect.PURE and not (
                eff is Effect.UNDOABLE and sc is Sys.PWRITE
                and self._staging_enabled):
            return IOFuture.resolved(self.intercept(sc, args))
        self.stats.intercepted += 1
        p = self.plan
        nid, ep = self._cur
        res = p.resolve_branches(nid, ep, self.ctx, False)
        if res is None or res[0] == END or p.sc[res[0]] is not sc:
            if self.strict and res is not None and res[0] != END \
                    and p.sc[res[0]] is not sc:
                raise GraphMismatch(
                    f"graph {self.plan.name!r}: expected {p.sc[res[0]]} at "
                    f"node {p.names[res[0]]!r}, application issued {sc}"
                )
            return IOFuture.resolved(self._exec_untracked(sc, args))
        fnid, fep = res[0], res[1]
        self._cur = (fnid, fep)
        self._frontier = (fnid, fep)

        # peek + batch submit, exactly as the blocking path would
        self._peek_and_preissue()

        key = (fnid, fep)
        st = self._state.get(key)
        if st is None:
            st = NodeState()
            self._state[key] = st
        if st.issued and st.req is not None \
                and st.req.state is not ReqState.CANCELLED \
                and not st.harvested \
                and not _spec_args_match(st.req.args, args):
            # harvest-time argument guard, async flavour: never hand out a
            # future backed by a request whose arguments drifted away from
            # the application's — resolve it synchronously instead and let
            # finish() account the stale completion as waste
            st.stale = True
            self.stats.stale_harvests += 1
        if st.issued and (st.req is None
                         or st.req.state is ReqState.CANCELLED
                         or st.stale):
            # evicted under pressure (shared backend) or stale under drift:
            # same demand fallback as a blocking intercept — serve
            # synchronously; the dead request stays in the ledger and is
            # counted at finish
            t0 = time.perf_counter()
            self.backend.note_demand()
            self.device.charge_crossing()
            result = self._serve_sync(sc, args)
            self.stats.sync_seconds += time.perf_counter() - t0
            self.stats.served_sync += 1
            save = p.save[fnid]
            if save is not None and not st.harvested:
                save(self.ctx, fep, result)
            st.harvested = True
            fut = IOFuture.resolved(result)
        else:
            if not st.issued:
                # beyond the peek window (depth exhausted or stub not ready
                # at peek time): demand-issue now — the request still rides
                # the async ledger, and the future defers the wait.  Built
                # via _make_request so an undoable write picks up its staged
                # runner (a bare IORequest would land the bytes in the
                # committed namespace before the txn publishes).
                req = self._make_request(fnid, args, False, fep, False)
                if req is None:  # effect gate refused: serve in place
                    return IOFuture.resolved(self.intercept(sc, args))
                st.issued = True
                st.req = req
                self.stats.pre_issued += 1
                if self.backend.submit([req]):
                    self.stats.submits += 1
            fut = IOFuture(
                st.req,
                resolver=lambda st=st, fnid=fnid, fep=fep:
                    self._harvest_late(st, fnid, fep))
            self.stats.futures_issued += 1
            self._futures.append(fut)

        # advance the frontier without serving it: resolution happens at
        # the future's demand point (or at finish's drain)
        lid = p.out_loop[fnid]
        if lid >= 0:
            fep = fep[:lid] + (fep[lid] + 1,) + fep[lid + 1:]
        self._cur = (p.out_dst[fnid], fep)
        if self._peek_dist > 0:
            self._peek_dist -= 1
        return fut

    def _harvest_late(self, st: NodeState, fnid: int,
                      fep: Tuple[int, ...]) -> Any:
        """Resolve one future: harvest its request exactly as a blocking
        intercept would.  ``backend.wait`` is the demand signal — on a
        shared backend it promotes a deferred chain with demand priority
        (``note_demanded``), so a future demand is indistinguishable from a
        blocking one to the slot scheduler."""
        req = st.req
        t0 = time.perf_counter()
        self.backend.wait(req)
        blocked = time.perf_counter() - t0
        self.stats.wait_seconds += blocked
        self.stats.served_async += 1
        if req.stage is not None and self.staging is not None:
            self.staging.on_demand(req.stage)
        t0 = time.perf_counter()
        result = req.take_result()
        self.stats.harvest_seconds += time.perf_counter() - t0
        save = self.plan.save[fnid]
        if save is not None and not st.harvested:
            save(self.ctx, fep, result)
        st.harvested = True
        if self.controller is not None and not self._finished:
            self.controller.on_serve(blocked, True, self.backend)
        return result

    def _serve_sync(self, sc: Sys, args: Tuple[Any, ...]) -> Any:
        """Serve the frontier synchronously.  With staging on, undoable
        syscalls stay inside the transaction even here: a session is a
        write transaction whether or not speculation got ahead, so the
        abort path can roll back demand writes too."""
        if self._staging_enabled and effect_of(sc, args) is Effect.UNDOABLE:
            txn = self._txn()
            if sc is Sys.OPEN:
                runner, rec = txn.stage_create(
                    args[0], args[1] if len(args) > 1 else "w")
            elif sc is Sys.RENAME:
                runner, rec = txn.stage_rename(args)
            elif not self._fd_is_staged(txn, args[0]):
                runner, rec = txn.stage_overwrite(args)
            else:  # write into a staged file: nothing extra to log
                return execute(self.device, sc, args)
            rec.demanded = True
            return runner(self.device)
        return execute(self.device, sc, args)

    def _exec_untracked(self, sc: Sys, args: Tuple[Any, ...]) -> Any:
        self.stats.untracked += 1
        # untracked closes are still publish barriers (plenty of wrapped
        # functions open through the graph but tear down outside it);
        # resolve the record before the close frees the fd number
        close_rec = None
        if sc is Sys.CLOSE and self.staging is not None:
            close_rec = self.staging.record_for_fd(args[0])
        self.device.charge_crossing()
        result = execute(self.device, sc, args)
        if close_rec is not None:
            self.staging.publish_close(close_rec)
        return result

    # -- teardown ------------------------------------------------------------
    def finish(self) -> SessionStats:
        """Cancel in-flight speculation and account for wasted work.

        Exception-safe and idempotent: even when ``intercept`` raised
        mid-batch (a stub error between the walk and ``submit``, a
        strict-mode :class:`GraphMismatch`, a failed request surfacing at
        ``wait``), every pre-issued-but-unharvested request is cancelled or
        drained exactly once — nothing may keep running into the next
        activation that reuses this backend, and nothing may be counted
        twice.  If cancellation itself raises, the drain and the wasted-work
        accounting still run before the error propagates.  Harvested reads
        released their registered-buffer leases at materialization
        (``take_result``); the leases still attached here — wasted
        completions and cancellations — are recycled strictly after the
        drain, when no worker can still be filling them.
        """
        if self._finished:
            return self.stats
        self._finished = True
        # Late futures settle FIRST, while the backend still runs.  A clean
        # exit drains-then-materializes them: result() after finish returns
        # bytes immediately instead of waiting on a torn-down backend (and
        # on the sync backend, whose ledgered requests only execute at
        # wait(), resolution *is* the execution — cancelling first would
        # lose their results).  A failed session poisons them instead:
        # speculated bytes from a function that raised must never be
        # trusted, and the cancellation sweep below then accounts their
        # requests as cancelled or wasted.
        if self._futures:
            futures, self._futures = self._futures, []
            for fut in futures:
                if fut.settled:
                    continue
                self.stats.futures_drained += 1
                if self._failed:
                    fut.poison(FuturePoisoned(
                        "session failed before this I/O future resolved"))
                else:
                    try:
                        fut.result()
                    except BaseException:
                        pass  # cached in the future; re-raised at result()
        try:
            # quarantined batch from a mid-walk stub error: these never
            # reached the backend, so cancel them here (they are in the
            # node-state ledger and must be accounted exactly once)
            for req in self._orphans:
                req.cancel()
            self.backend.cancel_remaining()
        finally:
            try:
                self.backend.drain()
            finally:
                # Account every pre-issued request from this session's own
                # node-state ledger, not from the backend's return value: on
                # a shared backend the scheduler may have evicted requests
                # mid-session, and a failed link head cancels its chain's
                # dependents on the worker — both must land in ``cancelled``
                # exactly once for the invariant
                #   pre_issued == served_async + cancelled + wasted_completions
                # to hold (tests/test_conformance.py checks it everywhere).
                for st in self._state.values():
                    if not st.issued or st.req is None:
                        continue
                    if st.req.state is ReqState.CANCELLED:
                        self.stats.cancelled += 1
                    elif st.req.state is ReqState.COMPLETED \
                            and (not st.harvested or st.stale):
                        # stale nodes were *served* (synchronously, after
                        # the argument guard rejected the speculation) but
                        # their pre-issued completion is pure waste
                        self.stats.wasted_completions += 1
                    if st.req.lease is not None:
                        # post-drain: no worker is filling it; harvested
                        # results already released at materialization
                        # (take_result), so this only recycles the leases
                        # of wasted completions and cancellations
                        st.req.drop_lease()
                try:
                    # settle the write transaction strictly after the drain:
                    # no staged runner can still be executing.  Success
                    # publishes what the frontier demanded and rolls back
                    # overshoot; failure rolls back everything unpublished.
                    if self.staging is not None:
                        self.staging.finalize(ok=not self._failed)
                finally:
                    if self.controller is not None:
                        self.controller.on_finish(
                            self.stats, time.perf_counter() - self._t0,
                            self.backend
                        )
        return self.stats
