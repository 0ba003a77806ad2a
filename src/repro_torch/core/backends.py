"""The unified I/O plane (paper §2.3, §5.4): one reactor, pluggable lanes.

Every backend in this module is one class — :class:`IOPlane` — configured
with *submission lanes*.  A lane is a queue pair: an ``io_workqueue`` worker
pool plus the crossing policy that models how entries reach it (one
``io_uring_enter`` per submitted batch, or one ordinary syscall per request
for the user-level thread pool).  The plane owns the submission queue, the
submitted-request ledger (one lock, acquired once per ``submit``), the
chain partitioner, and a :class:`repro_torch.core.buffers.BufferPool` of
registered buffers leased to PREAD requests at dispatch.

The historical five backends are lane configurations of that one reactor:

* ``SyncBackend`` — zero lanes: nothing runs early, demand executes inline
  at ``wait`` (the no-speculation baseline; also the conformance oracle, so
  it takes no buffer pool and keeps the classic allocate-per-request path).
* ``QueuePairBackend`` — one batched lane (io_uring analogue: one boundary
  crossing per submitted batch, harvest costs none).
* ``ThreadPoolBackend`` — one per-request lane (each entry pays its own
  crossing: an ordinary blocking syscall on some thread).
* ``MultiQueueBackend`` — one batched lane per sub-device of a
  :class:`repro_torch.core.device.ShardedDevice`; chains route whole by their
  head's target shard and each touched lane pays one crossing.
* ``SharedBackend`` + ``SlotScheduler`` — the multi-tenant layer, riding on
  top of any async plane unchanged in semantics: many concurrent sessions
  lease submission slots from one plane, with weighted-fair shares,
  priority classes, and pressure eviction of speculative-only requests.

Cross-references: docs/ARCHITECTURE.md ("Plan compilation & the unified I/O
plane", "Sharded multi-device substrate", "Shared-backend scheduling") maps
this module to paper §2.3/§5.4; see docs/GLOSSARY.md for *submission lane*,
*queue-pair crossing*, *registered buffer*, *tenant*, and *slot lease*.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .buffers import BufferPool
from .coalesce import ExtentCoalescer
from .completion import completion_pool
from .device import Device, ShardedDevice
from .lanes import SubmissionLane
from .syscalls import IORequest, ReqState, Sys, perform


class Backend:
    """Engine-facing interface — identical across backends (paper Table 1)."""

    name = "abstract"
    #: requests this backend can usefully run at once (worker count, summed
    #: across lanes); 0 = no async execution.  The adaptive depth
    #: controller stops growing once occupancy reaches this.
    capacity = 0

    def __init__(self, device: Device):
        self.device = device

    def inflight(self) -> int:
        """Submitted-but-incomplete request count (queue occupancy)."""
        return 0

    def prepare(self, req: IORequest) -> None:
        raise NotImplementedError

    def submit_all(self) -> int:
        """Make prepared requests eligible to run; returns #submitted."""
        raise NotImplementedError

    def submit(self, batch: List[IORequest]) -> int:
        """Submit a pre-formed batch in one call — the plan interpreter's
        fast path: the engine accumulates its peeked requests locally and
        hands them over with a single lock acquisition instead of one
        ``prepare`` crossing per request."""
        for req in batch:
            self.prepare(req)
        return self.submit_all()

    def wait(self, req: IORequest):
        raise NotImplementedError

    def cancel_remaining(self) -> int:
        """Cancel every request not yet executing (early exit, paper §6.4)."""
        raise NotImplementedError

    def drain(self) -> None:
        """Block until nothing is in flight (session teardown)."""
        raise NotImplementedError

    def spec_budget(self) -> Optional[int]:
        """Speculation-budget lease: how many requests this backend will let
        its session keep speculative at once, or None for unlimited (private
        backends).  The engine caps its peek depth here; on a
        :class:`SharedBackend` this is the tenant's weighted-fair share."""
        return None

    def note_demand(self) -> None:
        """Hint: the session is about to serve a request synchronously (a
        *demand* operation).  Shared backends use it to shed speculative
        queue pressure; private backends ignore it."""

    def shutdown(self) -> None:
        pass


def _chains(batch: List[IORequest]) -> List[List[IORequest]]:
    """Group a submitted batch into link chains (io_uring IOSQE_IO_LINK): a
    req with link=True executes before its successor, on the same worker."""
    chains: List[List[IORequest]] = []
    chain: List[IORequest] = []
    for req in batch:
        chain.append(req)
        if not req.link:
            chains.append(chain)
            chain = []
    if chain:  # trailing link=True at batch end — still a chain
        chains.append(chain)
    return chains


class IOPlane(Backend):
    """The unified reactor behind every backend name.

    One submission queue + submitted-request ledger behind a single lock
    (``submit`` acquires it once per batch — the paper's "one
    io_uring_enter per batch" submission-cost model, now also true of the
    Python-side locking), N :class:`SubmissionLane`\\ s, a chain router, and
    a registered :class:`BufferPool` leased to PREAD entries at dispatch.

    With zero lanes the plane degenerates to the synchronous baseline:
    nothing runs early, ``wait`` executes the request inline at demand time
    (and the ledger still lets ``cancel_remaining`` account every prepared
    entry, keeping the SessionStats invariant
    ``pre_issued == served_async + cancelled + wasted_completions``).
    """

    name = "io_plane"

    def __init__(self, device: Device, lanes: Sequence[SubmissionLane] = (),
                 router: Optional[Callable[[IORequest], int]] = None,
                 pool: Optional[BufferPool] = None,
                 coalesce: bool = False):
        super().__init__(device)
        self.lanes: List[SubmissionLane] = list(lanes)
        if len(self.lanes) > 1 and router is None:
            raise ValueError(
                "a multi-lane IOPlane needs a router (chains would all land "
                "on lane 0 while capacity reports every lane's workers)")
        self._router = router
        self.pool = pool
        #: extent coalescing (repro_torch.core.coalesce): fuse adjacent same-fd
        #: PREAD runs into super-reads at dispatch.  Off on the zero-lane
        #: (sync) plane regardless — the conformance oracle executes every
        #: request exactly as written.
        self.coalescer: Optional[ExtentCoalescer] = (
            ExtentCoalescer(pool) if coalesce and self.lanes else None)
        self.capacity = sum(lane.workers for lane in self.lanes)
        self._sq: List[IORequest] = []
        self._submitted: List[IORequest] = []
        # guards both queues: inflight()/drain() rebuild the _submitted ledger
        # and submit() swaps _sq — unguarded, concurrent sessions sharing
        # this plane lose ledger entries (requests that then never get
        # cancelled or drained).
        self._lock = threading.Lock()

    # -- engine surface ----------------------------------------------------
    def inflight(self) -> int:
        # prune completed entries while counting, keeping the ledger short
        with self._lock:
            self._submitted = [r for r in self._submitted if not r.is_done()]
            return len(self._submitted)

    def prepare(self, req: IORequest) -> None:
        with self._lock:
            self._sq.append(req)

    def submit_all(self) -> int:
        with self._lock:
            if not self._sq:
                return 0
            batch, self._sq = self._sq, []
        return self.submit(batch)

    #: amortized ledger-compaction threshold: above this many entries,
    #: submit() drops completed ones in place.  Without it a long-lived
    #: plane under open-loop load (sessions come and go, nobody calls
    #: ``inflight``) grows the ledger without bound.
    _LEDGER_COMPACT = 2048

    def submit(self, batch: List[IORequest]) -> int:
        if not batch:
            return 0
        if not self.lanes:
            # synchronous plane: entries only reach the ledger (they run at
            # wait); returns 0 — nothing was made eligible to run early
            with self._lock:
                self._submitted.extend(batch)
                if len(self._submitted) > self._LEDGER_COMPACT:
                    self._submitted = [r for r in self._submitted
                                       if not r.is_done()]
            return 0
        self._dispatch(batch)
        with self._lock:
            self._submitted.extend(batch)
            if len(self._submitted) > self._LEDGER_COMPACT:
                self._submitted = [r for r in self._submitted
                                   if not r.is_done()]
        return len(batch)

    # SharedBackend views stage their entries privately and submit through
    # here, so concurrent tenants can never interleave entries into each
    # other's link chains.
    submit_batch = submit

    def wait(self, req: IORequest):
        if not self.lanes:
            # the no-speculation baseline: demand I/O runs inline, paying
            # its own boundary crossing
            self.device.charge_crossing()
            req.finish(perform(self.device, req))
        if req.fused is not None:
            # a demanded member of a fused super-read whose carrier was
            # cancelled before executing is decomposed back to its own
            # per-extent read (repro_torch.core.coalesce) instead of blocking
            req.fused.on_demand(self.device, req)
        return req.wait_result()

    def cancel_remaining(self) -> int:
        with self._lock:
            pending, self._sq = self._sq, []
            submitted = list(self._submitted)
        n = 0
        for req in pending:
            if req.cancel():
                n += 1
        for req in submitted:
            if req.cancel():
                n += 1
        return n

    def drain(self) -> None:
        for lane in self.lanes:
            lane.drain()
        with self._lock:
            self._submitted = [r for r in self._submitted if not r.is_done()]

    def shutdown(self) -> None:
        for lane in self.lanes:
            lane.shutdown()

    # -- dispatch ----------------------------------------------------------
    def _lease_buffers(self, batch: List[IORequest]) -> None:
        """Attach registered-buffer leases to PREAD entries (READ_FIXED):
        the worker will fill recycled memory instead of allocating a result
        per request.  Pool exhaustion or odd shapes (staged runners,
        deferred size arguments) silently fall back to the classic path.

        On a coalescing plane, PWRITE entries with static payloads get the
        WRITE_FIXED analogue: the payload is copied into an aligned lease at
        dispatch (the registration copy) and the worker writes straight out
        of registered memory — on a direct-mode device the buffer is a
        valid O_DIRECT source."""
        pool = self.pool
        if pool is None:
            return
        align = 0
        if self.coalescer is not None:
            from .coalesce import _pool_alignment

            align = _pool_alignment(self.device)
        for req in batch:
            if req.sc is Sys.PREAD and req.runner is None \
                    and req.lease is None and isinstance(req.args[1], int):
                req.lease = pool.lease(req.args[1], tenant=req.tenant,
                                       alignment=align)
            elif self.coalescer is not None and req.sc is Sys.PWRITE \
                    and req.runner is None and req.lease is None \
                    and isinstance(req.args[1], (bytes, bytearray, memoryview)):
                data = req.args[1]
                lease = pool.lease(len(data), tenant=req.tenant,
                                   alignment=align)
                if lease is None:
                    continue
                n = len(data)
                lease.mv[:n] = data
                lease.filled(n)
                req.lease = lease
                fd, _, off = req.args
                req.runner = (lambda device, fd=fd, off=off, lease=lease,
                              n=n: device.pwrite(fd, lease.mv[:n], off))

    def _dispatch(self, batch: List[IORequest]) -> None:
        if self.coalescer is not None:
            chains = self.coalescer.fuse(_chains(batch))
            # satellites left the dispatch set; lease/charge only what runs
            batch = [r for chain in chains for r in chain]
            self._lease_buffers(batch)
        else:
            self._lease_buffers(batch)
            chains = _chains(batch)
        if len(self.lanes) == 1 or self._router is None:
            lane = self.lanes[0]
            lane.charge(len(batch))
            lane.push_batch(chains)
            return
        # multi-lane: whole chains route by their head (io_uring link
        # ordering survives), each touched lane pays one crossing and
        # receives its share of the batch in one ring fill
        routed: Dict[int, List[List[IORequest]]] = {}
        for chain in chains:
            routed.setdefault(self._router(chain[0]), []).append(chain)
        for li in sorted(routed):
            lane_chains = routed[li]
            self.lanes[li].charge(sum(len(c) for c in lane_chains))
            self.lanes[li].push_batch(lane_chains)


# ---------------------------------------------------------------------------
# Lane configurations: the historical backend names, one reactor underneath
# ---------------------------------------------------------------------------
class SyncBackend(IOPlane):
    """No speculation: zero lanes, requests execute at wait().

    Deliberately takes no buffer pool: this is the conformance oracle and
    keeps the classic allocate-per-request result path.
    """

    name = "sync"

    def __init__(self, device: Device):
        super().__init__(device, lanes=())


class QueuePairBackend(IOPlane):
    """io_uring analogue: one batched lane (SQ/CQ pair + io_workqueue).

    prepare()/submit() fill SQ entries with no crossings; dispatch costs
    exactly one boundary crossing for the whole batch; completions are
    harvested by waiting on the request's event (CQ poll — no crossing).
    """

    name = "io_uring"

    def __init__(self, device: Device, workers: int = 16,
                 coalesce: bool = False):
        super().__init__(device, lanes=(SubmissionLane(device, workers),),
                         pool=BufferPool(), coalesce=coalesce)


class ThreadPoolBackend(IOPlane):
    """User-level thread pool: same semantics, one crossing per request."""

    name = "user_threads"

    def __init__(self, device: Device, workers: int = 16,
                 coalesce: bool = False):
        super().__init__(
            device,
            lanes=(SubmissionLane(device, workers, per_request=True),),
            pool=BufferPool(),
            coalesce=coalesce,
        )


class MultiQueueBackend(IOPlane):
    """Per-device lanes over a :class:`ShardedDevice`.

    The engine sees the usual single prepare/submit/wait surface; internally
    each sub-device owns a lane sized ``workers`` (total concurrency =
    ``num_devices * workers``).  Chains route by the target shard of their
    head — never splitting across lanes — and every touched lane charges one
    crossing on its sub-device (one ``io_uring_enter`` per touched queue
    pair) plus the aggregate view.
    """

    name = "multi_queue"

    def __init__(self, device: Device, workers: int = 16,
                 coalesce: bool = False):
        if not isinstance(device, ShardedDevice):
            raise TypeError(
                "MultiQueueBackend requires a ShardedDevice "
                f"(got {type(device).__name__}); use 'io_uring' for flat devices"
            )
        # workers execute against the sharded device (vfd/namespace routing
        # happens there); the router decides *which* lane runs a chain and
        # which sub-device pays the crossing.
        super().__init__(
            device,
            lanes=[
                SubmissionLane(device, workers, crossing_device=sub,
                               aggregate=device.stats)
                for sub in device.devices
            ],
            router=self._route_head,
            pool=BufferPool(),
            coalesce=coalesce,
        )

    def _route_head(self, head: IORequest) -> int:
        dev: ShardedDevice = self.device  # type: ignore[assignment]
        try:
            return dev.route(head.sc, head.args)
        except OSError:
            return 0  # unknown fd (e.g. closed early): any lane can fail it


# ---------------------------------------------------------------------------
# Multi-tenant shared-backend scheduling
# ---------------------------------------------------------------------------
#: priority classes, ordered: higher value preempts lower-value speculation
PRIORITIES = {"low": 0, "normal": 1, "high": 2}


def resolve_priority(priority) -> int:
    if isinstance(priority, str):
        return PRIORITIES[priority]
    return int(priority)


class _TenantState:
    """Scheduler-side view of one tenant: its weight/priority, the live
    speculative-slot count, and the eviction-candidate ledger.

    ``spec_count`` is the authoritative occupancy (incremented at admission,
    decremented exactly once per request by the completion callback or by
    demand conversion); ``spec`` is only the *candidate list* for pressure
    eviction — it may lag behind (holding already-terminal or demanded
    entries, which eviction skips by flag) and is compacted amortized, so no
    path ever scans every tenant's whole ledger."""

    __slots__ = ("name", "weight", "priority", "views", "spec", "spec_count")

    def __init__(self, name: str, weight: float, priority: int):
        self.name = name
        self.weight = weight
        self.priority = priority
        self.views: set = set()
        # (request, owning view) — admitted speculation still worth evicting;
        # stale entries are skipped via req._spec_counted, not by scanning
        self.spec: List[Tuple[IORequest, "SharedBackend"]] = []
        self.spec_count = 0

    def compact(self) -> None:
        """Drop stale candidates once the list is far longer than the live
        count (amortized O(1) per admission)."""
        if len(self.spec) > 4 * self.spec_count + 16:
            self.spec = [(r, v) for (r, v) in self.spec
                         if getattr(r, "_spec_counted", False)]


class SlotScheduler:
    """Weighted-fair arbitration of one backend's submission slots.

    A *slot* is one speculative request in flight on the shared backend.
    Each tenant's share is ``capacity * weight / sum(active weights)``
    (at least 1); admission is per link chain (chains never split) and is
    denied once the tenant is at its share or the backend at capacity —
    denied chains stay staged in the tenant's view until capacity frees or
    the frontier *demands* them, at which point they bypass the budget
    entirely.  Under pressure, :meth:`make_room` cancels speculative-only
    requests that have not started executing, lowest priority class first,
    most-over-share tenant first, newest request first (LIFO wastes the
    least already-paid queue time).  Total speculative occupancy therefore
    never exceeds ``capacity``: a demand request can never wait behind more
    than ``capacity`` speculative ones.

    **Admission is O(chain), independent of tenant count.**  The original
    implementation pruned every tenant's request ledger and re-summed every
    tenant's occupancy on each ``admit``/``make_room`` — O(tenants ×
    requests) per admission, which at open-loop scale (thousands of
    sessions) turns the scheduler itself into the bottleneck.  Occupancy is
    now pure counter maintenance: admission increments ``spec_count`` /
    ``_spec_total``, and every admitted request carries a completion
    callback (:mod:`repro_torch.core.completion` fires it exactly once, on finish
    *or* cancel) that decrements them.  The active-weight sum behind the
    fair share is maintained incrementally at attach/detach.  Two locks,
    strictly ordered: ``_lock`` (outer — tenant table, candidate ledgers,
    active weight) and ``_count_lock`` (inner — the occupancy counters the
    completion callback touches; the callback takes only this one, so a
    worker finishing a request never contends with a long admission and
    never deadlocks against ``make_room`` cancelling under ``_lock``).
    """

    def __init__(self, capacity: int):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._count_lock = threading.Lock()
        self._tenants: Dict[str, _TenantState] = {}
        #: sum of weights of tenants with >= 1 attached view (under _lock)
        self._active_weight = 0.0
        #: authoritative speculative occupancy (under _count_lock)
        self._spec_total = 0
        #: tenants with spec_count > 0 — the only ones make_room must look
        #: at; bounded by capacity, not by tenant count (under _count_lock)
        self._spec_tenants: set = set()
        #: tenant names whose last slot freed after their last view detached
        #: (the callback cannot take _lock, so it queues the reap and the
        #: next attach/detach/admit sweeps it — the tenant table stays
        #: bounded by *live* tenants even at 10k sessions)
        self._reap: List[str] = []
        # observability (tests + bench report)
        self.max_spec_inflight = 0
        self.admitted = 0
        self.deferred = 0
        self.evictions = 0
        self.demand_promotions = 0

    # -- tenant lifecycle ---------------------------------------------------
    def _reap_idle(self) -> None:
        """Drop tenants whose last slot freed after detach (under _lock)."""
        with self._count_lock:
            names, self._reap = self._reap, []
            for name in names:
                t = self._tenants.get(name)
                if t is not None and not t.views and t.spec_count == 0:
                    self._spec_tenants.discard(t)
                    del self._tenants[name]

    def attach(self, view: "SharedBackend") -> None:
        with self._lock:
            self._reap_idle()
            t = self._tenants.get(view.tenant)
            if t is None:
                t = _TenantState(view.tenant, view.weight, view.priority)
                self._tenants[view.tenant] = t
                self._active_weight += t.weight
            else:
                # latest activation's weight/priority wins for the tenant
                if t.views:
                    self._active_weight += view.weight - t.weight
                else:
                    self._active_weight += view.weight
                t.weight = view.weight
                t.priority = view.priority
            t.views.add(view)

    def detach(self, view: "SharedBackend") -> None:
        with self._lock:
            t = self._tenants.get(view.tenant)
            if t is None:
                return
            had = view in t.views
            t.views.discard(view)
            if had and not t.views:
                self._active_weight -= t.weight
            with self._count_lock:
                if not t.views and t.spec_count == 0:
                    self._spec_tenants.discard(t)
                    del self._tenants[view.tenant]
            self._reap_idle()

    # -- shares -------------------------------------------------------------
    def _share_of(self, t: _TenantState) -> int:
        """Fair share from the incrementally maintained active-weight sum —
        O(1), requires _lock."""
        active_w = max(self._active_weight, t.weight, 1e-9)
        return max(1, int(self.capacity * t.weight / active_w))

    def fair_share(self, tenant: str) -> int:
        with self._lock:
            t = self._tenants.get(tenant)
            if t is None:
                return self.capacity
            return self._share_of(t)

    # -- completion accounting ---------------------------------------------
    def _spec_done(self, req: IORequest) -> None:
        """Completion callback: release the slot this request held.  Fired
        exactly once per admitted request (finish or cancel, whichever comes
        first — the completion pool guarantees the swap); requests already
        converted to demand carry a cleared flag and fall through."""
        with self._count_lock:
            if not getattr(req, "_spec_counted", False):
                return
            req._spec_counted = False
            ten: _TenantState = req._spec_tenant
            ten.spec_count -= 1
            self._spec_total -= 1
            if ten.spec_count == 0:
                self._spec_tenants.discard(ten)
                if not ten.views:
                    self._reap.append(ten.name)

    # -- admission ----------------------------------------------------------
    def admit(self, view: "SharedBackend",
              chains: List[List[IORequest]]) -> Tuple[List[List[IORequest]],
                                                      List[List[IORequest]]]:
        """Partition ``chains`` into (admitted, deferred).  Whole chains
        only; an over-length chain is still admitted when the tenant holds
        no slots at all (a tenant is never locked out of speculation
        entirely by a share smaller than its shortest chain)."""
        with self._lock:
            ten = self._tenants.get(view.tenant)
            if ten is None:  # detached view: nothing speculates anymore
                return [], chains
            share = self._share_of(ten)
            admitted: List[List[IORequest]] = []
            deferred: List[List[IORequest]] = []
            with self._count_lock:
                total = self._spec_total
                cnt = ten.spec_count
                for chain in chains:
                    n = len(chain)
                    fits_share = cnt + n <= share or cnt == 0
                    if fits_share and total + n <= self.capacity:
                        cnt += n
                        total += n
                        admitted.append(chain)
                        self.admitted += n
                    else:
                        deferred.append(chain)
                        # count each chain's first denial only: deferred
                        # chains are re-offered on every wait/flush, and
                        # counting the retries would inflate the metric by
                        # orders of magnitude
                        if not getattr(chain[0], "_defer_counted", False):
                            chain[0]._defer_counted = True
                            self.deferred += n
                if admitted:
                    ten.spec_count = cnt
                    self._spec_total = total
                    self._spec_tenants.add(ten)
                if total > self.max_spec_inflight:
                    self.max_spec_inflight = total
            # hook the slot release before the caller dispatches.  No
            # worker can touch these yet (the candidate append below is
            # what exposes them to eviction, and we still hold _lock), but
            # an IOFuture holds a direct reference to its request and may
            # cancel() it at any time — e.g. multi_get abandoning a tail
            # read whose chain was still deferred.  The stripe lock
            # serializes the hook against that terminal transition: a
            # request observed done here never takes a slot (its callback
            # already fired as a no-op and will never fire again).
            dead = 0
            for chain in admitted:
                for r in chain:
                    s = completion_pool().stripe(r)
                    with s.lock:
                        if r._done:
                            dead += 1
                            continue
                        r._spec_tenant = ten
                        r._spec_counted = True
                        r.completion_cb = self._spec_done
                    ten.spec.append((r, view))
            if dead:
                with self._count_lock:
                    ten.spec_count -= dead
                    self._spec_total -= dead
                    if ten.spec_count == 0:
                        self._spec_tenants.discard(ten)
            ten.compact()
            return admitted, deferred

    # -- demand -------------------------------------------------------------
    def note_demanded(self, view: "SharedBackend", req: IORequest) -> None:
        """A speculative request just became demanded (the frontier reached
        it): it no longer counts against anyone's budget and must never be
        evicted.  Clearing the flag both releases the slot now and turns the
        still-attached completion callback into a no-op (exactly-once)."""
        with self._count_lock:
            if not getattr(req, "_spec_counted", False):
                return
            req._spec_counted = False
            ten: _TenantState = req._spec_tenant
            ten.spec_count -= 1
            self._spec_total -= 1
            if ten.spec_count == 0:
                self._spec_tenants.discard(ten)

    def make_room(self, need: int = 1) -> int:
        """Pressure-triggered cancellation: free ``need`` slots for demand
        I/O by cancelling speculative requests that have not started
        executing.  Victim order: priority class ascending, occupancy/share
        ratio descending, newest request first.  Returns #evicted.

        The no-pressure fast path is one counter read; under pressure only
        tenants actually holding slots (``_spec_tenants``, bounded by
        capacity) are examined.  ``req.cancel()`` is issued outside
        ``_count_lock`` because it fires the slot-release callback, which
        takes ``_count_lock`` itself."""
        with self._count_lock:
            if self._spec_total + need <= self.capacity:
                return 0
        evicted = 0
        with self._lock:
            while True:
                with self._count_lock:
                    if self._spec_total + need <= self.capacity:
                        break
                    victims = sorted(
                        self._spec_tenants,
                        key=lambda t: (t.priority,
                                       -t.spec_count / self._share_of(t),
                                       t.name))
                progressed = False
                for t in victims:
                    for i in range(len(t.spec) - 1, -1, -1):
                        req, _view = t.spec[i]
                        if not getattr(req, "_spec_counted", False):
                            continue  # demanded or already terminal: immune
                        if req.state is not ReqState.PREPARED:
                            continue  # a worker is already running it
                        if req.cancel():  # atomic; fires the slot release
                            t.spec.pop(i)
                            self.evictions += 1
                            evicted += 1
                            progressed = True
                            break
                    if progressed:
                        break
                if not progressed:  # racing workers picked everything up
                    break
        return evicted

    def note_promotion(self) -> None:
        with self._lock:
            self.demand_promotions += 1

    def snapshot(self) -> Dict[str, int]:
        with self._lock, self._count_lock:
            return {
                "capacity": self.capacity,
                "tenants": len(self._tenants),
                "spec_inflight": self._spec_total,
                "max_spec_inflight": self.max_spec_inflight,
                "admitted": self.admitted,
                "deferred": self.deferred,
                "evictions": self.evictions,
                "demand_promotions": self.demand_promotions,
            }


class SharedBackend(Backend):
    """One session's lease on a shared async backend.

    Implements the engine-facing ``Backend`` surface, but every submission
    passes through the :class:`SlotScheduler`: prepared entries stage in a
    per-view queue, ``submit_all`` asks for slots chain-by-chain, and chains
    the scheduler defers stay staged until capacity frees or the frontier
    demands one of their requests — ``wait`` then *promotes* the chain past
    the budget (demand beats speculation, always).  ``cancel_remaining`` and
    ``drain`` are view-scoped: they touch only this session's requests, so
    one tenant tearing down never cancels or blocks on another tenant's
    work.
    """

    name = "shared"
    is_view = True

    def __init__(self, inner: IOPlane, scheduler: SlotScheduler,
                 tenant: str, weight: float = 1.0, priority=1):
        super().__init__(inner.device)
        self.inner = inner
        self.scheduler = scheduler
        self.tenant = tenant
        self.weight = float(weight)
        self.priority = resolve_priority(priority)
        self._lock = threading.Lock()
        self._sq: List[IORequest] = []  # prepared, not yet offered
        self._deferred: List[List[IORequest]] = []  # offered, denied slots
        self._submitted: List[IORequest] = []  # admitted or promoted
        self._closed = False
        scheduler.attach(self)

    # the adaptive depth controller gates growth on capacity/inflight; for a
    # view both are tenant-scoped: the fair share and this session's own
    # speculative occupancy.
    @property
    def capacity(self) -> int:  # type: ignore[override]
        return self.scheduler.fair_share(self.tenant)

    def spec_budget(self) -> Optional[int]:
        return self.scheduler.fair_share(self.tenant)

    def inflight(self) -> int:
        with self._lock:
            self._submitted = [r for r in self._submitted if not r.is_done()]
            return len(self._submitted) + sum(len(c) for c in self._deferred)

    #: priority stamp for demand-promoted chains: above every priority
    #: class, so promoted demand never queues behind anyone's speculation
    DEMAND_BOOST = 1 << 20

    def prepare(self, req: IORequest) -> None:
        req.priority = self.priority  # tenant class orders the worker queue
        req.tenant = self.tenant  # buffer leases charge this tenant's budget
        with self._lock:
            self._sq.append(req)

    def submit_all(self) -> int:
        with self._lock:
            batch, self._sq = self._sq, []
            if batch:
                self._deferred.extend(_chains(batch))
        return self._flush_deferred()

    def submit(self, batch: List[IORequest]) -> int:
        """The engine's single-call batch path: stamp the tenant's priority
        class, stage the chains, offer them to the scheduler — one lock
        acquisition, same admission semantics as prepare()+submit_all()."""
        if not batch:
            return 0
        for req in batch:
            req.priority = self.priority
            req.tenant = self.tenant
        with self._lock:
            self._deferred.extend(_chains(batch))
        return self._flush_deferred()

    def _flush_deferred(self) -> int:
        """Offer every staged chain to the scheduler and dispatch whatever
        it admits; chains denied slots go back to the staging queue.  The
        admitted set is dispatched as one flat batch — chain boundaries
        survive concatenation (a chain's last request has link=False), so
        this costs one crossing, like a private backend's submit_all."""
        with self._lock:
            chains, self._deferred = self._deferred, []
        if not chains:
            return 0
        # drop requests that went terminal while staged (a cancelled
        # IOFuture terminates its request in place) — re-offering them
        # would burn slots on work nobody will ever execute
        chains = [c for c in ([r for r in chain if not r.is_done()]
                              for chain in chains) if c]
        if not chains:
            return 0
        admitted, deferred = self.scheduler.admit(self, chains)
        with self._lock:
            self._deferred.extend(deferred)
        if not admitted:
            return 0
        batch = [r for chain in admitted for r in chain]
        n = self.inner.submit_batch(batch)
        with self._lock:
            self._submitted.extend(batch)
        return n

    def note_demand(self) -> None:
        """The session is about to run a demand op synchronously: shed
        speculative queue pressure so it is not stuck behind cold tenants'
        speculation, then give own deferred chains a chance."""
        self.scheduler.make_room(1)
        self._flush_deferred()

    def wait(self, req: IORequest):
        promoted: Optional[List[IORequest]] = None
        with self._lock:
            for i, chain in enumerate(self._deferred):
                if req in chain:
                    promoted = self._deferred.pop(i)
                    break
        if promoted is None:
            # completion frees slots: give deferred chains a chance before
            # blocking, so the pipeline refills without waiting for the
            # next prepare (otherwise a saturated tenant degenerates to
            # demand-at-a-time serial execution)
            self._flush_deferred()
        if promoted is not None:
            # demand promotion: bypass the speculation budget entirely —
            # evict other tenants' queued speculation if the queue is full,
            # and outrank every queued chain in the worker pool
            for r in promoted:
                r.priority = self.DEMAND_BOOST + self.priority
            self.scheduler.make_room(len(promoted))
            self.scheduler.note_promotion()
            self.inner.submit_batch(promoted)
            with self._lock:
                self._submitted.extend(promoted)
        else:
            self.scheduler.note_demanded(self, req)
        if req.fused is not None:
            # fused-satellite demand: if the carrier was evicted/cancelled
            # before scattering, serve this member's own extent inline
            req.fused.on_demand(self.device, req)
        try:
            return req.wait_result()
        except RuntimeError:
            if req.state is ReqState.CANCELLED and req.error is None:
                # evicted between the engine's state check and this wait:
                # serve it as demand inline.  Safe: eviction only cancels
                # PREPARED requests and workers skip anything not PREPARED,
                # so nobody else will ever execute it.
                self.device.charge_crossing()
                result = perform(self.device, req)
                req.finish(result)
                return result
            raise

    def cancel_remaining(self) -> int:
        with self._lock:
            pending, self._sq = self._sq, []
            for chain in self._deferred:
                pending.extend(chain)
            self._deferred = []
            submitted = list(self._submitted)
        n = 0
        for req in pending:
            if req.cancel():
                n += 1
        for req in submitted:
            if req.cancel():
                n += 1
        return n

    def drain(self) -> None:
        # view-scoped: wait for this session's submitted requests only —
        # never for other tenants' work on the shared pool.
        with self._lock:
            submitted = list(self._submitted)
        for req in submitted:
            req.wait_done()
        with self._lock:
            self._submitted = [r for r in self._submitted if not r.is_done()]

    def shutdown(self) -> None:
        """Release the lease (the inner backend is owned by the Foreactor
        and outlives every view)."""
        if self._closed:
            return
        self._closed = True
        self.scheduler.detach(self)


BACKENDS = {
    "sync": SyncBackend,
    "io_uring": QueuePairBackend,
    "user_threads": ThreadPoolBackend,
    "multi_queue": MultiQueueBackend,
}


def make_backend(name: str, device: Device, workers: int = 16,
                 coalesce: bool = False) -> Backend:
    """Instantiate a backend by name.

    ``name="auto"`` picks the best match for the device topology: per-device
    queue pairs for a :class:`ShardedDevice`, a single io_uring-style queue
    pair otherwise.  ``coalesce=True`` enables the plane's extent coalescer
    (ignored by the sync backend — the oracle never rewrites requests).
    """
    if name == "auto":
        name = "multi_queue" if isinstance(device, ShardedDevice) else "io_uring"
    cls = BACKENDS[name]
    if cls is SyncBackend:
        return cls(device)
    return cls(device, workers=workers, coalesce=coalesce)
