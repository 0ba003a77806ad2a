"""Typed syscall descriptors and I/O request records (paper §3.2).

Every syscall node falls into one of three *effect classes* (the paper's
§3.3 pure/non-pure split, refined so that write chains become speculable):

* **pure** — read-only; the only side effect is possibly bringing data into
  the OS page cache (pread, fstat, getdents, read-only open).  Always safe
  to pre-issue, even across weak edges.
* **undoable** — leaves persistent state that a staging layer can revert:
  pwrite (old bytes can be logged and replayed), truncating-create opens
  (the file can land in a staged name and be renamed into place later),
  and rename to a fresh destination (renaming back restores the namespace).
  Pre-issuable across weak edges *when the session runs a staging
  transaction* (:mod:`repro_torch.store.staging`); otherwise only when guaranteed.
* **barrier** — unrecoverable or ordering-bearing side effects: fsync,
  close, unlink (the removed bytes are gone), and opens of pre-existing
  files in write modes ("rw"/"a", whose
  prior contents a file-granularity stage cannot preserve).  Never
  pre-issued across a weak edge; serving one at the frontier is the
  *publish barrier* that commits the staged files behind it.

Cross-references: docs/ARCHITECTURE.md ("Syscall layer", "Undoable write
speculation"); *pure syscall*, *undoable syscall* and *publish barrier* are
defined in docs/GLOSSARY.md.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Optional, Tuple

from .completion import completion_pool


class Sys(Enum):
    OPEN = "open"
    CLOSE = "close"
    PREAD = "pread"
    PWRITE = "pwrite"
    FSTATAT = "fstatat"
    GETDENTS = "getdents"
    FSYNC = "fsync"
    RENAME = "rename"
    UNLINK = "unlink"


#: read-only syscalls with no externally visible side effect
PURE: frozenset = frozenset({Sys.PREAD, Sys.FSTATAT, Sys.GETDENTS})


class Effect(Enum):
    """Three-way side-effect classification of a (syscall, args) pair."""

    PURE = "pure"
    UNDOABLE = "undoable"
    BARRIER = "barrier"


def effect_of(sc: Sys, args: Tuple[Any, ...]) -> Effect:
    """Classify a concrete call.

    open(path, 'r') allocates an fd but leaves no persistent state and is
    cancellable via close — pure.  open(path, 'w') truncating-creates: the
    file can be staged under a temporary name and renamed into place at
    publish — undoable.  open with 'rw'/'a' mutates a file that may already
    exist, which file-granularity staging cannot revert — barrier.
    """
    if sc in PURE:
        return Effect.PURE
    if sc is Sys.OPEN:
        if len(args) < 2 or args[1] == "r":
            return Effect.PURE
        if args[1] == "w":
            return Effect.UNDOABLE
        return Effect.BARRIER
    if sc is Sys.PWRITE:
        return Effect.UNDOABLE
    if sc is Sys.RENAME:
        # renaming back restores the old namespace (staged renames assume a
        # fresh destination; see repro_torch.store.staging.StagingTxn.stage_rename)
        return Effect.UNDOABLE
    return Effect.BARRIER  # close, fsync, unlink


def is_pure(sc: Sys, args: Tuple[Any, ...]) -> bool:
    return effect_of(sc, args) is Effect.PURE


class FutureCancelled(RuntimeError):
    """Raised by :meth:`IOFuture.result` when the future was explicitly
    cancelled (:meth:`IOFuture.cancel`) before it resolved."""


class IOFuture:
    """First-class deferred I/O result (the futures-style session API).

    An unresolved future is a *harvestable ledger entry*: its
    :class:`IORequest` may already be in flight via speculation, and
    :meth:`result` is a *late demand point* — the engine harvests (or
    demand-promotes, on a shared backend) the request only when the caller
    finally needs the bytes, so compute between issue and ``result()``
    overlaps with I/O with zero new threads.

    Resolution runs at most once, under an internal lock; the value or
    error is cached, so repeated ``result()`` calls are cheap and a failed
    session's *poisoned* futures keep raising the same error.  A future is
    also a valid graph-stub input: :class:`FromRequest` accepts one, so a
    consumer node's argument can be "whatever this future resolves to".
    """

    __slots__ = ("req", "_resolver", "_lock", "_done_flag", "_value", "_error")

    def __init__(self, req: Optional["IORequest"] = None,
                 resolver: Optional[Callable[[], Any]] = None):
        self.req = req
        self._resolver = resolver
        self._lock = threading.Lock()
        self._done_flag = False
        self._value: Any = None
        self._error: Optional[BaseException] = None

    @classmethod
    def resolved(cls, value: Any) -> "IOFuture":
        """An already-materialized future (the no-session / recorder path)."""
        f = cls()
        f._done_flag = True
        f._value = value
        return f

    def done(self) -> bool:
        """True once ``result()`` is guaranteed not to block: the future is
        resolved, poisoned, or its request has reached a terminal state."""
        if self._done_flag:
            return True
        return self.req is not None and self.req.is_done()

    @property
    def settled(self) -> bool:
        """True once the future's value or error is pinned (resolved,
        poisoned, or cancelled).  Unlike :meth:`done`, completion of the
        underlying request alone does not settle a future — the session's
        finish() drain materializes completed-but-unresolved ones."""
        return self._done_flag

    def result(self) -> Any:
        """Resolve (demand) the future; returns the same bytes the blocking
        ``io.*`` call would have, or raises the same error it would have."""
        with self._lock:
            if not self._done_flag:
                try:
                    if self._resolver is not None:
                        self._value = self._resolver()
                    elif self.req is not None:
                        self._value = self.req.wait_result()
                except BaseException as e:
                    self._error = e
                self._done_flag = True
                self._resolver = None
            if self._error is not None:
                raise self._error
            return self._value

    def poison(self, error: BaseException) -> bool:
        """Mark an unresolved future as failed — ``result()`` will raise
        ``error`` forever after.  No-op (False) if already resolved."""
        with self._lock:
            if self._done_flag:
                return False
            self._done_flag = True
            self._error = error
            self._resolver = None
            return True

    def cancel(self) -> bool:
        """Abandon an unresolved future: its request is cancelled if still
        queued (counted *cancelled* in the session ledger; a completed one
        becomes a *wasted completion* at finish), and ``result()`` raises
        :class:`FutureCancelled` from now on.  False if already resolved."""
        with self._lock:
            if self._done_flag:
                return False
            self._done_flag = True
            self._error = FutureCancelled("I/O future was cancelled")
            self._resolver = None
        if self.req is not None:
            self.req.cancel()
        return True


class FromRequest:
    """Deferred argument: the result of another (linked) request.

    Used by Link'ed read->write pairs (paper §4.1, Fig. 4b): the pwrite's
    data argument *is* the internal buffer the linked pread populates, with
    no intermediate copy.  Linked chains run in order on one worker, so the
    producer has completed by the time the consumer executes.

    Also accepts an :class:`IOFuture`: a consumer node's argument can be a
    future another part of the program holds — resolution then routes
    through the future (so the session's late-demand accounting and the
    future's cached value/error stay authoritative).
    """

    def __init__(self, req):
        if isinstance(req, IOFuture):
            self._future: Optional[IOFuture] = req
            self.req = req.req
        else:
            self._future = None
            self.req = req

    def resolve(self):
        if self._future is not None:
            return self._future.result()
        # The producer may have been submitted in an earlier batch and still
        # be in flight; block until it completes.  (Inside a Link chain the
        # producer has necessarily finished already.)
        self.req.wait_done()
        if self.req.error is not None:
            raise self.req.error
        if self.req.result is None and self.req.state.name == "CANCELLED":
            raise RuntimeError("deferred argument's producer was cancelled")
        # materialize (never hand out the registered buffer itself: the
        # lease is recycled at session teardown and a raw view would dangle)
        return self.req.take_result()


def resolve_args(args: Tuple[Any, ...]) -> Tuple[Any, ...]:
    return tuple(a.resolve() if isinstance(a, FromRequest)
                 else a.result() if isinstance(a, IOFuture)
                 else a for a in args)


def execute(device, sc: Sys, args: Tuple[Any, ...]):
    """Dispatch a syscall descriptor against a Device."""
    args = resolve_args(args)
    if sc is Sys.OPEN:
        return device.open(*args)
    if sc is Sys.CLOSE:
        return device.close(*args)
    if sc is Sys.PREAD:
        return device.pread(*args)
    if sc is Sys.PWRITE:
        return device.pwrite(*args)
    if sc is Sys.FSTATAT:
        return device.fstatat(*args)
    if sc is Sys.GETDENTS:
        return device.getdents(*args)
    if sc is Sys.FSYNC:
        return device.fsync(*args)
    if sc is Sys.RENAME:
        return device.rename(*args)
    if sc is Sys.UNLINK:
        return device.unlink(*args)
    raise ValueError(f"unknown syscall {sc}")


def perform(device, req: "IORequest"):
    """Execute one request against a device, honouring its staged runner
    and its registered-buffer lease.

    Every execution site (worker pools, the sync backend's deferred
    execution, the shared backend's inline demand fallback) must go through
    here — calling ``execute`` directly would bypass staging and land a
    speculative write in the committed namespace.

    A leased PREAD reads *into* its registered buffer
    (:meth:`repro_torch.core.device.Device.pread_into`): no per-request result
    allocation on the device side, and a speculated read the function never
    demands costs zero allocations.  The request's result is the lease;
    consumers materialize bytes through :meth:`IORequest.take_result`.
    """
    if req.runner is not None:
        return req.runner(device)
    lease = req.lease
    if lease is not None and req.sc is Sys.PREAD:
        fd, size, offset = resolve_args(req.args)
        n = device.pread_into(fd, lease.mv[:size], offset)
        lease.filled(n)
        return lease
    return execute(device, req.sc, req.args)


class ReqState(Enum):
    PREPARED = 0  # in the submission queue, not yet visible to the 'kernel'
    SUBMITTED = 1  # picked up by the io_workqueue
    COMPLETED = 2  # result in the completion queue
    CANCELLED = 3  # cancelled before execution (early function exit)


@dataclass
class IORequest:
    """One entry in the submission queue.

    ``link`` forces this request to be executed before the next one in the
    same submitted batch on the same worker (io_uring IOSQE_IO_LINK).
    """

    sc: Sys
    args: Tuple[Any, ...]
    link: bool = False
    tag: Any = None  # (node id, epoch) — used by the engine to find it again
    #: staged execution override: when set, workers call ``runner(device)``
    #: instead of ``execute(device, sc, args)`` — the staging layer uses it
    #: to redirect a speculative create to its staged name or to capture an
    #: overwrite's undo bytes before the write lands
    runner: Optional[Callable[[Any], Any]] = None
    #: the StageRecord this request belongs to, if its side effect is staged
    #: (undo/publish bookkeeping lives in repro_torch.store.staging)
    stage: Any = None
    #: for CLOSE requests: the staged-create record this close is the
    #: publish barrier of.  Resolved at pre-issue time, while the fd is
    #: provably still open — resolving at harvest would race with OS
    #: fd-number reuse once the worker-executed close freed the number.
    barrier_for: Any = None
    #: dispatch priority (io_uring's IOSQE ioprio analogue): worker pools
    #: run higher values first; shared-backend views stamp their tenant's
    #: priority class here, demand promotions outrank all speculation
    priority: int = 0
    #: registered-buffer lease (repro_torch.core.buffers), attached by the I/O
    #: plane at dispatch time for PREAD requests; the worker fills it, and
    #: the engine releases it back to the pool at session teardown
    lease: Any = None
    #: owning tenant name on a shared backend (stamped by the view alongside
    #: the priority class); the buffer pool charges leases against it
    tenant: Optional[str] = None
    #: the FusedRead this request belongs to, when the plane's extent
    #: coalescer fused it into a super-read (repro_torch.core.coalesce).  Backends
    #: consult it on demand-wait: a satellite whose carrier was cancelled or
    #: failed is decomposed back to its own per-extent read.
    fused: Any = field(default=None, repr=False)
    #: completion hook — fired exactly once, on whichever of finish/cancel
    #: terminates the request first (the slot scheduler hangs its O(1) slot
    #: accounting here).  Fired outside the stripe lock; must not block.
    completion_cb: Optional[Callable[["IORequest"], None]] = \
        field(default=None, repr=False)
    state: ReqState = ReqState.PREPARED
    result: Any = None
    error: Optional[BaseException] = None
    #: terminal flag, readable lock-free under the GIL (result/error/state
    #: are written strictly before it); blocking waits ride the process-wide
    #: completion pool (repro_torch.core.completion) instead of a per-request
    #: Event — zero lock allocations on the per-request hot path.
    _done: bool = field(default=False, repr=False)

    def is_done(self) -> bool:
        """True once the request reached COMPLETED or CANCELLED."""
        return self._done

    def wait_done(self, timeout: Optional[float] = None) -> bool:
        """Block until the request is terminal; False on timeout."""
        return completion_pool().wait(self, timeout)

    def finish(self, result: Any = None, error: Optional[BaseException] = None) -> None:
        self.result = result
        self.error = error
        self.state = ReqState.COMPLETED
        s = completion_pool().stripe(self)
        with s.lock:
            cb, self.completion_cb = self.completion_cb, None
            self._done = True
            if s.waiters:
                s.cond.notify_all()
        if cb is not None:
            cb(self)

    def claim(self) -> bool:
        """Atomically take PREPARED -> SUBMITTED (a worker about to execute
        it); False means it was already claimed, cancelled, or completed.
        The stripe lock serializes this against cancel(): whoever loses must
        see the other's state — otherwise a cancelled request could still
        execute (or execute twice via the demand-promotion fallback)."""
        s = completion_pool().stripe(self)
        with s.lock:
            if self.state is ReqState.PREPARED:
                self.state = ReqState.SUBMITTED
                return True
            return False

    def cancel(self) -> bool:
        s = completion_pool().stripe(self)
        with s.lock:
            if self.state is not ReqState.PREPARED:
                return False
            self.state = ReqState.CANCELLED
            cb, self.completion_cb = self.completion_cb, None
            self._done = True
            if s.waiters:
                s.cond.notify_all()
        if cb is not None:
            cb(self)
        return True

    def take_result(self):
        """The request's result with any registered-buffer lease
        materialized to ``bytes`` (paper Fig. 10's result copy — exactly one
        bounded memcpy, cached so repeated consumers share the object).

        Materialization releases the lease: once the bytes are copied out,
        nothing reads the registered buffer again, so it goes back to the
        pool *mid-session* instead of at teardown — a long session's pool
        occupancy stays O(depth), not O(reads).  The stripe lock serializes
        concurrent consumers (two futures, a future plus a ``FromRequest``
        stub): exactly one copies and releases; the rest see bytes."""
        lease = None
        s = completion_pool().stripe(self)
        with s.lock:
            r = self.result
            if self.lease is not None and r is self.lease:
                lease, self.lease = self.lease, None
                r = lease.to_bytes()
                self.result = r
        if lease is not None:
            lease.release()
        return r

    def drop_lease(self) -> None:
        """Return an unconsumed lease to the pool (wasted completions and
        cancellations at session teardown); idempotent with take_result."""
        s = completion_pool().stripe(self)
        with s.lock:
            lease, self.lease = self.lease, None
            if self.result is lease:
                self.result = None
        if lease is not None:
            lease.release()

    def wait_result(self):
        self.wait_done()
        if self.error is not None:
            raise self.error
        if self.state is ReqState.CANCELLED:
            raise RuntimeError("waited on a cancelled I/O request")
        return self.result
