"""Submission lanes: the execution machinery under the I/O plane.

A :class:`SubmissionLane` is one queue pair — an in-process ``io_workqueue``
worker pool (:class:`_WorkerPool`) plus the crossing policy for how entries
reach it.  :class:`repro_torch.core.backends.IOPlane` owns the submission queue
and ledger and routes whole link chains here; this module owns execution:
priority-ordered dispatch, chain link semantics (a failed head cancels its
dependents), claim/cancel atomicity against early exits and scheduler
eviction, and batched ring fills (one lock acquisition per submitted
batch).

Cross-references: docs/ARCHITECTURE.md ("Plan compilation & the unified I/O
plane"); *submission lane* and *queue-pair crossing* are defined in
docs/GLOSSARY.md.
"""

from __future__ import annotations

import heapq
import threading
from typing import List, Optional, Sequence, Tuple

from .completion import CompletionPool, completion_pool  # noqa: F401 — the
# lane-level completion machinery (CQ analogue) lives in repro_torch.core.completion;
# re-exported here because lanes are where completions are produced
from .device import Device, DeviceStats
from .syscalls import IORequest, perform


class _WorkerPool:
    """Shared worker-pool machinery (the 'io_workqueue').

    The queue is priority-ordered (FIFO within a priority level via the
    sequence counter): a multi-tenant backend stamps requests with their
    tenant's priority class, so a hot tenant's chains never wait behind a
    cold tenant's queued speculation.  Single-tenant backends leave every
    request at priority 0 — plain FIFO, as before.

    Submission is *batched*: :meth:`push_chains` enqueues a whole
    submission's chains under one lock acquisition and wakes at most one
    waiter per queued chain — the in-process analogue of filling the SQ
    ring and crossing once, and the difference between O(chains) and O(1)
    lock traffic on the engine's measured peek path (a per-chain
    ``PriorityQueue.put`` costs a mutex round-trip + condition signal per
    chain, which under 16 running workers dominates the submission cost the
    paper's Fig. 10 attributes to the pre-issuing algorithm).
    """

    _SHUTDOWN_PRIORITY = -(1 << 30)  # drains after all real work

    def __init__(self, device: Device, workers: int):
        self.device = device
        self._heap: List[Tuple[int, int, Optional[List[IORequest]]]] = []
        self._seq = 0
        self._inflight = 0
        self._lock = threading.Lock()
        self._ready = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._threads = [
            threading.Thread(target=self._run, name=f"io_workqueue-{i}", daemon=True)
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()
        self._shutdown = False

    def push_chains(self, chains: Sequence[List[IORequest]]) -> None:
        """Enqueue every chain of one submitted batch: one lock acquisition
        for the whole batch (the SQ-ring fill), then wake workers."""
        if not chains:
            return
        with self._lock:
            self._inflight += len(chains)
            seq = self._seq
            for chain in chains:
                heapq.heappush(self._heap, (-chain[0].priority, seq, chain))
                seq += 1
            self._seq = seq
            if len(chains) == 1:
                self._ready.notify()
            else:
                self._ready.notify_all()

    def push_chain(self, chain: List[IORequest]) -> None:
        self.push_chains((chain,))

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._heap:
                    self._ready.wait()
                _prio, _seq, chain = heapq.heappop(self._heap)
            if chain is None:
                return
            try:
                for req in chain:
                    # atomically claim the request; a failed claim means it
                    # was cancelled (early exit / scheduler eviction) or
                    # served inline by a demand promotion — executing it here
                    # would double a side effect.
                    if not req.claim():
                        continue
                    try:
                        req.finish(perform(self.device, req))
                    except BaseException as e:  # propagate to the waiter
                        req.finish(error=e)
                        # a failed link head breaks the chain (io_uring semantics)
                        for rest in chain[chain.index(req) + 1 :]:
                            rest.cancel()
                        break
            finally:
                with self._lock:
                    self._inflight -= 1
                    if self._inflight == 0:
                        self._idle.notify_all()

    def drain(self) -> None:
        with self._lock:
            while self._inflight > 0:
                self._idle.wait()

    def shutdown(self) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        with self._lock:
            for _ in self._threads:
                seq = self._seq
                self._seq += 1
                heapq.heappush(self._heap,
                               (-self._SHUTDOWN_PRIORITY, seq, None))
            self._ready.notify_all()
        for t in self._threads:
            t.join(timeout=5)


class SubmissionLane:
    """One queue pair of the I/O plane: an io_workqueue plus the crossing
    policy that models how entries enter it.

    ``exec_device`` is what the workers execute requests against (for a
    sharded plane this is the *sharded* device — vfd/namespace routing
    happens inside it); ``crossing_device`` is who pays the boundary
    crossing (the owning sub-device on a sharded plane).  ``per_request``
    selects the thread-pool cost model (one crossing per entry) over the
    io_uring one (one crossing per submitted batch); ``aggregate`` is an
    optional extra stats sink so a sharded device's aggregate crossing
    count stays consistent with its sub-devices'.
    """

    __slots__ = ("workers", "per_request", "crossing_device", "aggregate",
                 "_pool")

    def __init__(self, exec_device: Device, workers: int,
                 per_request: bool = False,
                 crossing_device: Optional[Device] = None,
                 aggregate: Optional[DeviceStats] = None):
        self.workers = workers
        self.per_request = per_request
        self.crossing_device = crossing_device if crossing_device is not None \
            else exec_device
        self.aggregate = aggregate
        self._pool = _WorkerPool(exec_device, workers)

    def charge(self, n_requests: int) -> None:
        """Pay this submission's boundary crossings (one ``io_uring_enter``
        for the whole batch, or one syscall per request)."""
        if self.per_request:
            for _ in range(n_requests):
                self.crossing_device.charge_crossing()
        else:
            self.crossing_device.charge_crossing()
        if self.aggregate is not None:
            self.aggregate.crossing()

    def push(self, chain: List[IORequest]) -> None:
        self._pool.push_chain(chain)

    def push_batch(self, chains: Sequence[List[IORequest]]) -> None:
        """All of one submission's chains in one workqueue lock acquisition."""
        self._pool.push_chains(chains)

    def drain(self) -> None:
        self._pool.drain()

    def shutdown(self) -> None:
        self._pool.shutdown()
