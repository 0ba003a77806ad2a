"""Plan-level extent coalescing: fuse adjacent PREADs into super-reads.

The foreaction graph gives the engine *exact* future syscall arguments
(paper §2's premise), which is precisely what is needed to safely make
requests bigger, not just earlier: a run of PREAD records on the same fd
whose ``(offset, size)`` pairs are statically known and exactly adjacent
(``offset_{i+1} == offset_i + size_i`` — the loop-provenance shapes the
miner emits for checkpoint restore and sequential data pipelines) is fused
into ONE MB-scale *super-read* backed by a single aligned buffer lease.
On devices whose cost is ``base_latency + bytes * per_byte`` (every real
disk, and :class:`repro_torch.core.device.SimulatedDevice`), N tiny reads pay N
base latencies while one fused read pays one — the difference between
~17 MB/s and ~800 MB/s per channel at 1 KiB vs 1 MiB request size on the
NVMe profile.

Mechanics (the carrier/satellite model):

* The fuse pass (:meth:`ExtentCoalescer.fuse`) runs inside the I/O plane's
  dispatch, on the link-chain partition of a submitted batch.  Only runs of
  >= 2 *single-request* chains fuse (link chains carry ordering the fusion
  would destroy); the first member becomes the **carrier** — it stays in
  the dispatched chain list with a ``runner`` that executes the super-read
  — and the rest become **satellites**, removed from dispatch but kept in
  every ledger, so cancellation and the session's accounting invariant
  (``pre_issued == served_async + cancelled + wasted_completions``) see
  them exactly as before.
* On a full read the carrier's runner *scatters*: each satellite is claimed
  and finished with a zero-copy :class:`repro_torch.core.buffers.LeaseView` into
  the shared slab (its sub-range of the super-read); the carrier itself
  returns the parent lease trimmed to its own extent.
* A short read (EOF inside the fused range) or an exception **decomposes**:
  every member is re-executed as its own per-extent pread, so EOF
  boundaries and per-extent errors (EIO mid-run) surface byte-identically
  to the unfused/sync execution — each satellite terminates exactly once,
  with its own result or its own error.
* A carrier cancelled before execution (early exit, pressure eviction)
  leaves satellites PREPARED; ``cancel_remaining`` reaches them through the
  ledgers, and a *demanded* satellite is decomposed on the spot by
  :meth:`FusedRead.on_demand` (the backend ``wait`` hook).

Cross-references: docs/ARCHITECTURE.md ("Direct I/O & extent coalescing");
*super-read*, *scatter view*, *alignment class* and *direct lane* are
defined in docs/GLOSSARY.md.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from .buffers import BufferPool
from .syscalls import IORequest, Sys

#: fused reads cap at the pool's top size class (4 MiB): bigger would run
#: unleased and allocate per request, forfeiting the registered-buffer win
MAX_FUSED_BYTES = 1 << 22

#: a run shorter than this is left alone (nothing to fuse)
MIN_RUN = 2


class CoalesceStats:
    """Counters for the fuse pass and the fused-read lifecycle."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.super_reads = 0  # FusedRead objects created
        self.extents_fused = 0  # member requests covered (incl. carriers)
        self.bytes_fused = 0  # sum of fused byte ranges
        self.scatters = 0  # full reads scattered to views
        self.decompositions = 0  # short-read / error fallbacks
        self.demand_decompositions = 0  # satellite demanded after carrier died
        self.unleased_fallbacks = 0  # pool declined; plain-buffer super-read

    def bump(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "super_reads": self.super_reads,
                "extents_fused": self.extents_fused,
                "bytes_fused": self.bytes_fused,
                "scatters": self.scatters,
                "decompositions": self.decompositions,
                "demand_decompositions": self.demand_decompositions,
                "unleased_fallbacks": self.unleased_fallbacks,
            }


def _pool_alignment(device) -> int:
    """Map a device's logical block size onto the pool's alignment classes."""
    a = getattr(device, "alignment", 0) or 0
    if a <= 0:
        return 0
    return 512 if a <= 512 else 4096


class FusedRead:
    """One super-read covering ``members`` (adjacent PREADs on one fd).

    ``members[0]`` is the carrier: it keeps its place in the dispatched
    chains and carries :meth:`run` as its staged runner; the rest are
    satellites, finished by the carrier's execution (scatter or decompose)
    or — if the carrier is cancelled first — by ``cancel_remaining`` /
    :meth:`on_demand`.
    """

    __slots__ = ("members", "fd", "offset", "total", "pool", "stats",
                 "_rel")

    def __init__(self, members: List[IORequest], pool: Optional[BufferPool],
                 stats: CoalesceStats):
        self.members = members
        self.fd = members[0].args[0]
        self.offset = members[0].args[2]
        self.total = sum(r.args[1] for r in members)
        self.pool = pool
        self.stats = stats
        # per-member (start offset relative to the fused range, size)
        rel, off = [], 0
        for r in members:
            rel.append((off, r.args[1]))
            off += r.args[1]
        self._rel = rel
        for r in members:
            r.fused = self
        carrier = members[0]
        carrier.runner = self.run

    # -- execution (the carrier's staged runner) ---------------------------
    def run(self, device) -> Any:
        """Execute the super-read; returns the carrier's own result (the
        worker finishes the carrier with it, like any staged runner)."""
        lease = None
        if self.pool is not None:
            lease = self.pool.lease(self.total,
                                    tenant=self.members[0].tenant,
                                    alignment=_pool_alignment(device))
        try:
            if lease is not None:
                n = device.pread_into(self.fd, lease.mv[: self.total],
                                      self.offset)
            else:
                self.stats.bump("unleased_fallbacks")
                data = device.pread(self.fd, self.total, self.offset)
                n = len(data)
        except BaseException:
            if lease is not None:
                lease.release()
            return self._decompose(device)
        if n < self.total:
            # EOF inside the fused range: per-extent re-reads reproduce the
            # exact short-read boundary each member would have seen unfused
            if lease is not None:
                lease.release()
            return self._decompose(device)
        self.stats.bump("scatters")
        if lease is not None:
            return self._scatter_lease(lease)
        return self._scatter_bytes(data)

    def _scatter_lease(self, lease) -> Any:
        carrier = self.members[0]
        for i in range(1, len(self.members)):
            sat = self.members[i]
            if not sat.claim():  # cancel won the race; it is terminal
                continue
            start, size = self._rel[i]
            view = lease.view(start, size)
            sat.lease = view
            sat.finish(view)
        # the carrier keeps the parent lease, trimmed to its own extent;
        # take_result materializes bytes[0:size0] and drops the parent ref
        # (the slab recycles once every scatter view releases too)
        lease.filled(self._rel[0][1])
        carrier.lease = lease
        return lease

    def _scatter_bytes(self, data: bytes) -> bytes:
        for i in range(1, len(self.members)):
            sat = self.members[i]
            if not sat.claim():
                continue
            start, size = self._rel[i]
            sat.finish(data[start: start + size])
        size0 = self._rel[0][1]
        return data[:size0]

    def _decompose(self, device) -> Any:
        """Per-extent fallback: every member runs as its own pread, so
        short reads and errors land on exactly the extent that owns them.
        The carrier's own outcome is returned/raised (the worker finishes
        it); each satellite is finished here, exactly once."""
        self.stats.bump("decompositions")
        carrier_result: Any = None
        carrier_error: Optional[BaseException] = None
        for i, req in enumerate(self.members):
            fd, size, off = req.args
            if i == 0:
                try:
                    carrier_result = device.pread(fd, size, off)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    carrier_error = e
                continue
            if not req.claim():
                continue
            try:
                req.finish(device.pread(fd, size, off))
            except BaseException as e:  # noqa: BLE001 — satellite's own error
                req.finish(error=e)
        if carrier_error is not None:
            raise carrier_error
        return carrier_result

    # -- demand hook (backend.wait) ----------------------------------------
    def on_demand(self, device, req: IORequest) -> None:
        """Called by the backend when the frontier demands ``req``.  For a
        satellite this waits out the carrier (it always reaches a terminal
        state once dispatched: a worker runs it or cancellation takes it)
        and, if the carrier died without scattering, serves the satellite's
        own extent inline — the demand-decomposition path."""
        if req.is_done() or req is self.members[0]:
            return
        self.members[0].wait_done()
        if req.is_done():
            return
        if not req.claim():
            return
        self.stats.bump("demand_decompositions")
        fd, size, off = req.args
        device.charge_crossing()
        try:
            req.finish(device.pread(fd, size, off))
        except BaseException as e:  # noqa: BLE001 — the extent's own error
            req.finish(error=e)


class ExtentCoalescer:
    """The fuse pass the I/O plane runs over each dispatched batch."""

    def __init__(self, pool: Optional[BufferPool],
                 max_bytes: int = MAX_FUSED_BYTES):
        self.pool = pool
        self.max_bytes = max_bytes
        self.stats = CoalesceStats()

    @staticmethod
    def _fusable(chain: List[IORequest]) -> bool:
        """Only bare single-request PREADs with fully static int args fuse;
        link chains, staged runners, already-leased or already-terminal
        entries pass through untouched."""
        if len(chain) != 1:
            return False
        r = chain[0]
        return (r.sc is Sys.PREAD and not r.link and r.runner is None
                and r.lease is None and r.fused is None and not r.is_done()
                and len(r.args) == 3
                and isinstance(r.args[0], int)
                and isinstance(r.args[1], int) and r.args[1] > 0
                and isinstance(r.args[2], int))

    def fuse(self, chains: List[List[IORequest]]) -> List[List[IORequest]]:
        """Rewrite a chain list, replacing each adjacent same-fd run with
        its carrier; satellites leave the dispatch set (their terminal
        state now comes from the carrier or from cancellation)."""
        out: List[List[IORequest]] = []
        run: List[IORequest] = []
        run_bytes = 0

        def flush() -> None:
            nonlocal run, run_bytes
            if len(run) >= MIN_RUN:
                fused = FusedRead(run, self.pool, self.stats)
                self.stats.bump("super_reads")
                self.stats.bump("extents_fused", len(run))
                self.stats.bump("bytes_fused", fused.total)
                out.append([run[0]])
            else:
                out.extend([r] for r in run)
            run, run_bytes = [], 0

        for chain in chains:
            if not self._fusable(chain):
                flush()
                out.append(chain)
                continue
            r = chain[0]
            fd, size, off = r.args
            if run:
                prev = run[-1]
                adjacent = (fd == prev.args[0]
                            and off == prev.args[2] + prev.args[1])
                if not adjacent or run_bytes + size > self.max_bytes:
                    flush()
            run.append(r)
            run_bytes += size
        flush()
        return out
