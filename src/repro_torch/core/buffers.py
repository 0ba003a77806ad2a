"""Registered buffer pool for the I/O plane (paper Fig. 10 "result copy").

io_uring lets an application *register* a fixed set of buffers with the
kernel once (``io_uring_register(IORING_REGISTER_BUFFERS)``) and then issue
``IORING_OP_READ_FIXED`` against them, so the hot path never allocates a
per-request buffer.  This module is that idea for the
:class:`repro_torch.core.backends.IOPlane`: a size-classed pool of pre-allocated
``bytearray`` buffers that are *leased* to ``IORequest``s at submission time,
filled by the worker via :meth:`repro_torch.core.device.Device.pread_into` (no
per-request allocation on the device side), and returned to the pool when the
session finishes.

Why it pays off in this runtime: the unpooled read path allocates twice per
pread (the device slices its backing store into a fresh ``bytearray``, then
wraps it in ``bytes``), and speculative reads that the function never demands
(cancelled / wasted completions — the paper's early-exit overhead) pay that
allocation for nothing.  A leased read does one copy into a recycled buffer;
a *wasted* leased read allocates nothing at all, and a harvested one pays
exactly one materialize copy (``IORequest.take_result``) — the paper's
result-copy, now bounded and measured.

Lease lifecycle (enforced by the plane + engine, not by this module):

1. ``pool.lease(size)`` at submission — ``None`` when the pool is at
   capacity, in which case the request simply runs unleased (the classic
   allocate-per-request path; registered buffers are a fixed budget, exactly
   like io_uring's).
2. The worker fills ``lease.mv`` and records the byte count via
   ``lease.filled(n)``.
3. Consumers (the frontier harvest, ``FromRequest.resolve``) call
   ``IORequest.take_result`` which materializes ``bytes`` at most once.
4. ``lease.release()`` at session teardown, strictly after the backend
   drain — no worker can still be writing into the buffer, and every
   consumer holds materialized ``bytes``, never the buffer itself.

Cross-references: docs/ARCHITECTURE.md ("Plan compilation & the unified I/O
plane"); *registered buffer* and *buffer lease* are defined in
docs/GLOSSARY.md.
"""

from __future__ import annotations

import mmap
import threading
from typing import Dict, List, Optional, Tuple

#: size classes: powers of two from 512 B to 4 MiB.  Requests above the top
#: class run unleased (huge reads are rare and amortize their allocation).
_MIN_CLASS = 9  # 2**9 = 512
_MAX_CLASS = 22  # 2**22 = 4 MiB

#: alignment classes accepted by :meth:`BufferPool.lease`.  0 means "any
#: address" (plain ``bytearray`` slab); 512 and 4096 are the two logical
#: block sizes O_DIRECT cares about.  Aligned slabs are anonymous ``mmap``
#: regions, which the kernel hands back page-aligned — one slab kind
#: satisfies both nonzero classes.
ALIGNMENT_CLASSES = (0, 512, 4096)


def size_class(size: int) -> Optional[int]:
    """The smallest power-of-two class holding ``size`` bytes, or None if
    the size is out of the registered range."""
    if size <= 0 or size > (1 << _MAX_CLASS):
        return None
    c = _MIN_CLASS
    while (1 << c) < size:
        c += 1
    return c


class BufferLease:
    """One registered buffer, on loan from the pool to one ``IORequest``.

    Leases are refcounted: the dispatching request holds the initial ref,
    and additional consumers that must read ``mv`` later (a ``FromRequest``
    stub, an unresolved future) take one via :meth:`addref`.  The buffer
    goes back to the pool when the *last* holder releases — which, since
    ``IORequest.take_result`` materializes bytes and releases at first
    demand, happens mid-session rather than at teardown."""

    __slots__ = ("pool", "cls", "buf", "mv", "nbytes", "tenant", "aligned",
                 "_refs")

    def __init__(self, pool: "BufferPool", cls: int, buf,
                 tenant: Optional[str] = None, aligned: bool = False):
        self.pool = pool
        self.cls = cls
        self.buf = buf
        self.mv = memoryview(buf)
        self.nbytes = 0
        self.tenant = tenant
        #: True when ``buf`` is a page-aligned mmap slab (valid O_DIRECT
        #: target); recycles into the aligned free list
        self.aligned = aligned
        self._refs = 1

    def filled(self, n: int) -> None:
        """Record how many bytes the device wrote (short reads included)."""
        self.nbytes = n

    def to_bytes(self) -> bytes:
        """Materialize the filled prefix — the result copy of paper Fig. 10,
        exactly one bounded memcpy out of the registered buffer."""
        return bytes(self.mv[: self.nbytes])

    def addref(self) -> "BufferLease":
        """Register one more holder; pairs with one :meth:`release`."""
        with self.pool._lock:
            if self._refs <= 0:
                raise RuntimeError("addref on a released buffer lease")
            self._refs += 1
        return self

    def release(self) -> None:
        """Drop one holder's ref; the last drop returns the buffer to the
        pool.  Extra releases are ignored (teardown paths and first-demand
        materialization may both try).  Callers must ensure no consumer
        still reads ``mv`` past their release."""
        with self.pool._lock:
            if self._refs <= 0:
                return
            self._refs -= 1
            if self._refs > 0:
                return
            self.pool._give_back_locked(self)

    def view(self, start: int, nbytes: int) -> "LeaseView":
        """A zero-copy window into this buffer — the *scatter view* a fused
        super-read hands each covered extent.  Takes one ref on this lease;
        the slab recycles only after every view (and the carrier) releases."""
        if start < 0 or start + nbytes > len(self.mv):
            raise ValueError(f"view [{start}, {start + nbytes}) outside "
                             f"lease of {len(self.mv)} bytes")
        self.addref()
        return LeaseView(self, start, nbytes)

    def __len__(self) -> int:
        return self.nbytes


class LeaseView:
    """Zero-copy sub-range of a :class:`BufferLease` (one scattered extent
    of a fused super-read).  Quacks like a lease for the consumer paths that
    matter — ``to_bytes`` / ``release`` / ``mv`` — so ``IORequest.take_result``
    and session teardown need no special casing.  Releasing a view drops the
    ref it holds on the parent lease; the parent's slab goes back to the
    pool when the last view/carrier releases."""

    __slots__ = ("parent", "start", "nbytes", "_refs")

    def __init__(self, parent: BufferLease, start: int, nbytes: int):
        self.parent = parent
        self.start = start
        self.nbytes = nbytes
        self._refs = 1

    @property
    def mv(self) -> memoryview:
        return self.parent.mv[self.start: self.start + self.nbytes]

    def filled(self, n: int) -> None:
        self.nbytes = n

    def to_bytes(self) -> bytes:
        return bytes(self.parent.mv[self.start: self.start + self.nbytes])

    def addref(self) -> "LeaseView":
        with self.parent.pool._lock:
            if self._refs <= 0:
                raise RuntimeError("addref on a released lease view")
            self._refs += 1
        self.parent.addref()
        return self

    def release(self) -> None:
        # extra releases are ignored, like BufferLease.release: teardown
        # and first-demand materialization may both try
        with self.parent.pool._lock:
            if self._refs <= 0:
                return
            self._refs -= 1
        self.parent.release()

    def __len__(self) -> int:
        return self.nbytes


class BufferPool:
    """Size-classed pool of pre-allocated, recycled I/O buffers.

    ``capacity_bytes`` bounds the total registered memory (leased + idle),
    like io_uring's fixed registration: when the budget is exhausted,
    :meth:`lease` returns ``None`` and the request falls back to the
    allocate-per-request path instead of blocking.  Thread-safe; stats are
    exposed to benchmarks (``bench_overhead``) and tests.

    **Per-tenant budgets** (multi-tenant serving): when a lease names a
    tenant, the class size is charged against that tenant's
    ``tenant_budget_bytes`` slice of the registered memory and refunded at
    release.  A tenant at its budget is declined — it falls back to the
    allocate-per-request path for *its own* reads — without touching the
    free lists, so one huge-read tenant can never drain the recycled
    buffers every other tenant's leases ride on.  Untenanted leases
    (private, single-session backends) are uncharged, as before.
    """

    def __init__(self, capacity_bytes: int = 64 << 20,
                 tenant_budget_bytes: Optional[int] = None):
        self.capacity_bytes = capacity_bytes
        #: per-tenant slice of the registered memory; the default (1/8 of
        #: capacity) lets a handful of hot tenants saturate the pool while
        #: no single one can claim more than its slice
        self.tenant_budget_bytes = (capacity_bytes // 8
                                    if tenant_budget_bytes is None
                                    else tenant_budget_bytes)
        #: free lists keyed (size class, aligned?) — aligned slabs are mmap
        #: regions and must never satisfy (or be polluted by) plain leases
        self._free: Dict[Tuple[int, bool], List] = {}
        self._lock = threading.Lock()
        #: total bytes currently registered (idle + leased)
        self.registered_bytes = 0
        #: bytes currently charged to each tenant (leased, not yet refunded)
        self._charged: Dict[str, int] = {}
        # observability
        self.leases = 0
        self.recycle_hits = 0
        self.grows = 0
        self.declined = 0
        self.budget_declines = 0
        self.released = 0
        #: leases handed out from page-aligned mmap slabs (O_DIRECT-ready)
        self.aligned_leases = 0
        #: occupancy gauges — the mid-session recycling regression surface:
        #: a session of R harvested reads must peak at O(depth), not O(R)
        self.leased_now = 0
        self.peak_leased = 0

    def lease(self, size: int, tenant: Optional[str] = None,
              alignment: int = 0) -> Optional[BufferLease]:
        """Lease a registered buffer of at least ``size`` bytes.

        ``alignment`` (0, 512 or 4096) asks for a buffer whose base address
        is a valid O_DIRECT target; aligned slabs come from anonymous
        ``mmap`` (page-aligned, so one slab kind serves both classes) and
        the tenant budget charges the same ``1 << cls`` as a plain lease.
        """
        if alignment not in ALIGNMENT_CLASSES:
            raise ValueError(f"alignment must be one of {ALIGNMENT_CLASSES},"
                             f" got {alignment}")
        aligned = alignment > 0
        cls = size_class(size)
        if cls is None:
            with self._lock:
                self.declined += 1
            return None
        nbytes = 1 << cls
        with self._lock:
            if tenant is not None:
                charged = self._charged.get(tenant, 0)
                if charged + nbytes > self.tenant_budget_bytes:
                    # over budget: this tenant allocates classically; the
                    # free lists stay untouched for everyone else
                    self.declined += 1
                    self.budget_declines += 1
                    return None
            free = self._free.get((cls, aligned))
            if free:
                buf = free.pop()
                self.recycle_hits += 1
            else:
                if self.registered_bytes + nbytes > self.capacity_bytes:
                    self.declined += 1
                    return None
                buf = mmap.mmap(-1, nbytes) if aligned else bytearray(nbytes)
                self.registered_bytes += nbytes
                self.grows += 1
            if tenant is not None:
                self._charged[tenant] = self._charged.get(tenant, 0) + nbytes
            self.leases += 1
            if aligned:
                self.aligned_leases += 1
            self.leased_now += 1
            if self.leased_now > self.peak_leased:
                self.peak_leased = self.leased_now
        return BufferLease(self, cls, buf, tenant, aligned=aligned)

    def _give_back_locked(self, lease: BufferLease) -> None:
        """Recycle a fully-released lease; caller holds ``self._lock``."""
        self.released += 1
        self.leased_now -= 1
        if lease.tenant is not None:
            left = self._charged.get(lease.tenant, 0) - (1 << lease.cls)
            if left > 0:
                self._charged[lease.tenant] = left
            else:  # fully refunded: drop the entry (bounded tenant map)
                self._charged.pop(lease.tenant, None)
        self._free.setdefault((lease.cls, lease.aligned), []).append(lease.buf)

    def charged_bytes(self, tenant: str) -> int:
        """Bytes currently charged to ``tenant`` (0 once fully refunded)."""
        with self._lock:
            return self._charged.get(tenant, 0)

    @property
    def hit_rate(self) -> float:
        return self.recycle_hits / self.leases if self.leases else 0.0

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {
                "registered_bytes": self.registered_bytes,
                "leases": self.leases,
                "recycle_hits": self.recycle_hits,
                "hit_rate": self.recycle_hits / self.leases if self.leases
                else 0.0,
                "grows": self.grows,
                "declined": self.declined,
                "budget_declines": self.budget_declines,
                "released": self.released,
                "aligned_leases": self.aligned_leases,
                "leased_now": self.leased_now,
                "peak_leased": self.peak_leased,
                "tenants_charged": len(self._charged),
            }
