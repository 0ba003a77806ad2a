"""Storage device layer.

Foreactor's syscall nodes ultimately hit a storage device. On the paper's
testbed that is a Toshiba NVMe SSD behind ext4; in this framework the same
role is played by a ``Device`` object so that

* ``OSDevice`` issues the real host syscalls (os.pread/os.pwrite/...), and
* ``SimulatedDevice`` wraps any device with the paper's Fig.-1 cost model:
  every operation occupies one of ``channels`` internal units for
  ``base_latency + bytes * per_byte`` seconds.  This makes the storage-I/O-
  parallelism effect (throughput scaling with queue depth until channels
  saturate) deterministic and measurable inside a CI container whose page
  cache would otherwise hide it.

A *boundary crossing* models the user/kernel transition cost: io_uring-style
backends pay one crossing per submitted batch, thread-pool/sync backends pay
one per request (paper §2.3, Table 1).

``ShardedDevice`` composes N independent sub-devices under one namespace
(``shard3:/path`` addresses sub-device 3) so that pre-issued batches can fan
out across devices and aggregate bandwidth approaches ``sum(BW_i)``; it pairs
with :class:`repro_torch.core.backends.MultiQueueBackend`, which keeps one queue
pair per sub-device.

Cross-references: docs/ARCHITECTURE.md ("Device layer", "Sharded multi-device
substrate") maps this module to paper §2.1/Fig. 1; terms like *queue-pair
crossing* are defined in docs/GLOSSARY.md.
"""

from __future__ import annotations

import os
import re
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class DeviceStats:
    """Operation counters, used by benchmarks and tests."""

    ops: int = 0
    read_bytes: int = 0
    write_bytes: int = 0
    crossings: int = 0
    inflight: int = 0
    max_inflight: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def op_begin(self) -> None:
        with self._lock:
            self.ops += 1
            self.inflight += 1
            self.max_inflight = max(self.max_inflight, self.inflight)

    def op_end(self, read_bytes: int = 0, write_bytes: int = 0) -> None:
        with self._lock:
            self.inflight -= 1
            self.read_bytes += read_bytes
            self.write_bytes += write_bytes

    def crossing(self) -> None:
        with self._lock:
            self.crossings += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "ops": self.ops,
                "read_bytes": self.read_bytes,
                "write_bytes": self.write_bytes,
                "crossings": self.crossings,
                "max_inflight": self.max_inflight,
            }


class Device:
    """Abstract storage device: the sink for all syscall nodes."""

    stats: DeviceStats

    #: logical-block alignment (bytes) that direct-I/O transfers on this
    #: device must honor — offset, length and buffer address all multiples
    #: of it.  0 means the device takes any shape (buffered path); devices
    #: opened in direct mode report 512 or 4096.  The buffer pool
    #: (:meth:`repro_torch.core.buffers.BufferPool.lease`) and the extent
    #: coalescer key their aligned leases off this value.
    alignment: int = 0

    def open(self, path: str, flags: str = "r") -> int:
        raise NotImplementedError

    def close(self, fd: int) -> None:
        raise NotImplementedError

    def pread(self, fd: int, size: int, offset: int) -> bytes:
        raise NotImplementedError

    def pwrite(self, fd: int, data: bytes, offset: int) -> int:
        raise NotImplementedError

    def pread_into(self, fd: int, buf, offset: int) -> int:
        """Read up to ``len(buf)`` bytes at ``offset`` *into* a
        caller-provided writable buffer (a registered-buffer lease from
        :class:`repro_torch.core.buffers.BufferPool`); returns the byte count.

        The io_uring READ_FIXED analogue: the device fills registered
        memory instead of allocating a fresh result object per request.
        The default implementation falls back to :meth:`pread` + copy so
        every device works; devices with a reachable backing store
        override it to skip the intermediate allocation."""
        data = self.pread(fd, len(buf), offset)
        n = len(data)
        buf[:n] = data
        return n

    def fstatat(self, path: str) -> os.stat_result:
        raise NotImplementedError

    def getdents(self, path: str) -> List[str]:
        raise NotImplementedError

    def fsync(self, fd: int) -> None:
        raise NotImplementedError

    # -- staging support (repro_torch.store.staging) ----------------------------
    # rename/unlink/truncate are not syscall nodes (graphs never speculate
    # them); they are the namespace operations the staging layer needs to
    # publish (rename staged -> final), undo (unlink a staged file), and
    # roll back an extending overwrite (truncate to the old end).
    def rename(self, src: str, dst: str) -> None:
        raise NotImplementedError

    def unlink(self, path: str) -> None:
        raise NotImplementedError

    def truncate(self, fd: int, size: int) -> None:
        raise NotImplementedError

    def supports_staging(self) -> bool:
        """True iff rename/unlink/truncate are implemented — the gate for
        undoable write speculation on this device."""
        return False

    # cost hook for the user/kernel boundary; real devices pay it implicitly.
    def charge_crossing(self) -> None:
        self.stats.crossing()

    def place(self, path: str, hint: int = 0) -> str:
        """Return the path at which a file striped with index ``hint`` should
        live.  Flat devices ignore the hint; :class:`ShardedDevice` maps it to
        a ``shard{k}:`` namespace so callers (checkpoint manager, data
        pipeline) spread their shard files across sub-devices without knowing
        the device topology."""
        return path


_FLAGS = {
    "r": os.O_RDONLY,
    "w": os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
    "rw": os.O_RDWR | os.O_CREAT,
    "a": os.O_WRONLY | os.O_CREAT | os.O_APPEND,
}


class OSDevice(Device):
    """Direct host filesystem device (real syscalls).

    ``direct=True`` opens read-only data files with ``O_DIRECT`` — the
    *direct lane*: transfers DMA straight between the device and aligned
    user memory, skipping the page cache.  Support is probed per open (a
    filesystem that refuses — tmpfs, some overlayfs — raises ``EINVAL`` at
    open time), and refusal falls back to buffered I/O per fd, counted in
    ``direct_fallbacks``; nothing in CI hard-requires O_DIRECT to work.
    While direct mode is active, :attr:`alignment` reports the logical
    block size direct transfers must honor; unaligned reads on a direct fd
    transparently bounce through a page-aligned mmap buffer covering the
    aligned superset of the requested range."""

    def __init__(self, direct: bool = False) -> None:
        self.stats = DeviceStats()
        self.direct = direct
        self.alignment = 4096 if direct else 0
        self._direct_fds: set = set()
        self._fd_lock = threading.Lock()
        #: probe counters: opens that got O_DIRECT vs. refused-and-buffered
        self.direct_opens = 0
        self.direct_fallbacks = 0

    def open(self, path: str, flags: str = "r") -> int:
        self.stats.op_begin()
        try:
            if flags != "r":
                parent = os.path.dirname(path)
                if parent and not os.path.isdir(parent):
                    os.makedirs(parent, exist_ok=True)
            if self.direct and flags == "r" and hasattr(os, "O_DIRECT"):
                try:
                    fd = os.open(path, _FLAGS[flags] | os.O_DIRECT, 0o644)
                except OSError:
                    # this mount refuses O_DIRECT: buffered fallback, per fd
                    with self._fd_lock:
                        self.direct_fallbacks += 1
                else:
                    with self._fd_lock:
                        self._direct_fds.add(fd)
                        self.direct_opens += 1
                    return fd
            return os.open(path, _FLAGS[flags], 0o644)
        finally:
            self.stats.op_end()

    def close(self, fd: int) -> None:
        self.stats.op_begin()
        try:
            os.close(fd)
            with self._fd_lock:
                self._direct_fds.discard(fd)
        finally:
            self.stats.op_end()

    def _is_direct(self, fd: int) -> bool:
        with self._fd_lock:
            return fd in self._direct_fds

    def _direct_pread_raw(self, fd: int, size: int, offset: int) -> bytes:
        """Bounce read on an O_DIRECT fd: read the aligned superset
        [floor(offset), ceil(offset+size)) into a page-aligned mmap buffer,
        then slice the requested window (short reads at EOF included)."""
        import mmap

        a = self.alignment or 4096
        lo = (offset // a) * a
        hi = ((offset + size + a - 1) // a) * a
        bounce = mmap.mmap(-1, hi - lo)
        try:
            n = os.preadv(fd, [bounce], lo)
            start = offset - lo
            end = min(n, start + size)
            return bytes(bounce[start:end]) if end > start else b""
        finally:
            bounce.close()

    def pread(self, fd: int, size: int, offset: int) -> bytes:
        self.stats.op_begin()
        try:
            if self._is_direct(fd):
                return self._direct_pread_raw(fd, size, offset)
            data = os.pread(fd, size, offset)
            return data
        finally:
            self.stats.op_end(read_bytes=size)

    def pwrite(self, fd: int, data: bytes, offset: int) -> int:
        self.stats.op_begin()
        try:
            return os.pwrite(fd, data, offset)
        finally:
            self.stats.op_end(write_bytes=len(data))

    def pread_into(self, fd: int, buf, offset: int) -> int:
        self.stats.op_begin()
        try:
            if self._is_direct(fd):
                a = self.alignment or 4096
                if offset % a == 0 and len(buf) % a == 0:
                    try:
                        # aligned lease + aligned shape: true direct DMA
                        # into registered memory (READ_FIXED on the direct
                        # lane); EINVAL means the buffer address itself is
                        # unaligned — bounce below
                        return os.preadv(fd, [buf], offset)
                    except OSError:
                        pass
                data = self._direct_pread_raw(fd, len(buf), offset)
                n = len(data)
                buf[:n] = data
                return n
            # scatter-read straight into the registered buffer: the kernel
            # fills caller memory, no intermediate bytes object
            return os.preadv(fd, [buf], offset)
        finally:
            self.stats.op_end(read_bytes=len(buf))

    def fstatat(self, path: str) -> os.stat_result:
        self.stats.op_begin()
        try:
            return os.stat(path)
        finally:
            self.stats.op_end()

    def getdents(self, path: str) -> List[str]:
        self.stats.op_begin()
        try:
            return sorted(os.listdir(path))
        finally:
            self.stats.op_end()

    def fsync(self, fd: int) -> None:
        self.stats.op_begin()
        try:
            os.fsync(fd)
        finally:
            self.stats.op_end()

    def rename(self, src: str, dst: str) -> None:
        self.stats.op_begin()
        try:
            parent = os.path.dirname(dst)
            if parent and not os.path.isdir(parent):
                os.makedirs(parent, exist_ok=True)
            os.replace(src, dst)
        finally:
            self.stats.op_end()

    def unlink(self, path: str) -> None:
        self.stats.op_begin()
        try:
            try:
                os.unlink(path)
            except (IsADirectoryError, PermissionError):
                # empty-directory removal rides the same verb: the checkpoint
                # GC graph unlinks a step directory after emptying it, and a
                # non-empty directory still fails (OSError) as it should
                os.rmdir(path)
        finally:
            self.stats.op_end()

    def truncate(self, fd: int, size: int) -> None:
        self.stats.op_begin()
        try:
            os.ftruncate(fd, size)
        finally:
            self.stats.op_end()

    def supports_staging(self) -> bool:
        return True


@dataclass(frozen=True)
class DeviceProfile:
    """Latency/parallelism profile (paper Fig. 1 / §6 experimental setup).

    The default profile models the storage tier a TPU-pod *host* actually
    talks to — a remote/parallel blob store (ms-scale per-op latency, high
    aggregate parallelism).  Python's ``time.sleep`` granularity (~100 us)
    makes microsecond-scale NVMe emulation unmeasurable in-process, so the
    paper's 60 us-class NVMe profile is provided as :data:`NVME_PROFILE`
    for reference but benchmarks default to :data:`REMOTE_PROFILE`.  The
    *shape* of the effect (throughput scales with queue depth until the
    device's internal parallelism saturates) is identical — only the time
    constant changes.
    """

    channels: int = 16  # independent internal units (channels/dies/servers)
    base_latency: float = 2e-3  # per-op command+seek time (seconds)
    per_byte: float = 1.25e-9  # streaming cost per byte per channel (~800 MB/s)
    crossing_cost: float = 5e-6  # one user/kernel boundary crossing
    metadata_latency: float = 1.5e-3  # fstat/getdents/open service time
    #: page-cache *hit* service time: the syscall still happens and the
    #: kernel still memcpys out of the cache, so a hit charges a small fixed
    #: cost plus a per-byte memcpy term (~10 GB/s) — a 1 MB cached read is
    #: NOT free the way a 1 KB one nearly is.  Hits occupy no device channel.
    cache_hit_latency: float = 5e-6
    cache_hit_per_byte: float = 1e-10

    def raw_bandwidth_bytes(self) -> float:
        """Aggregate streaming ceiling (bytes/s) with every channel busy on
        infinitely large requests — the denominator for 'fraction of raw
        device bandwidth' in ``bench_bandwidth``."""
        if self.per_byte <= 0:
            return float("inf")
        return self.channels / self.per_byte


#: default: remote blob / parallel-FS tier of a training cluster
REMOTE_PROFILE = DeviceProfile()

#: the paper's Toshiba NVMe (~60 MB/s @ QD1/4 KB => ~66 us/op; ~1.2 GB/s peak).
#: Useful for unit tests of the cost model, too fine-grained to benchmark
#: under Python sleep granularity.
NVME_PROFILE = DeviceProfile(
    channels=16,
    base_latency=60e-6,
    per_byte=1.2e-9,
    crossing_cost=2.5e-6,
    metadata_latency=40e-6,
)


def _precise_sleep(dur: float) -> None:
    """``time.sleep`` has a ~1 ms floor inside CI containers, which would
    inflate microsecond-scale costs (boundary crossings, ~5 us) two hundred
    fold and drown the effect being modelled.  Spin for those; sleep for
    anything >= 100 us — spinning holds the GIL, so longer busy-waits would
    serialize the worker pools this device model exists to exercise."""
    if dur <= 0:
        return
    if dur >= 1e-4:
        time.sleep(dur)
        return
    end = time.perf_counter() + dur
    while time.perf_counter() < end:
        pass


class _PageCacheModel:
    """A tiny LRU model of the kernel page cache (paper §6.3 varies its
    capacity via cgroups).  Cache hits serve data without charging device
    latency — the syscall still happens, it is just fast."""

    def __init__(self, capacity_bytes: int, page: int = 4096):
        from collections import OrderedDict

        self.page = page
        self.capacity_pages = max(1, capacity_bytes // page)
        self._lru: "OrderedDict[tuple, bool]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def _pages(self, path: str, offset: int, size: int):
        first = offset // self.page
        last = (offset + max(size, 1) - 1) // self.page
        return [(path, i) for i in range(first, last + 1)]

    def access(self, path: str, offset: int, size: int, insert: bool = True) -> bool:
        """True iff fully cached; inserts pages (LRU evict) either way."""
        keys = self._pages(path, offset, size)
        with self._lock:
            hit = all(k in self._lru for k in keys)
            if insert:
                for k in keys:
                    if k in self._lru:
                        self._lru.move_to_end(k)
                    else:
                        self._lru[k] = True
                        if len(self._lru) > self.capacity_pages:
                            self._lru.popitem(last=False)
            if hit:
                self.hits += 1
            else:
                self.misses += 1
            return hit


class SimulatedDevice(Device):
    """Wraps an inner device with a K-channel latency model.

    Each operation holds one channel slot while it 'executes', so wall time
    improves with concurrency up to ``channels`` — the storage-I/O-parallelism
    effect the paper exploits.  The data itself is served by the inner device
    (correctness is real; only timing is synthetic).  ``cache_bytes`` > 0
    enables the page-cache model: cached preads skip the device charge but
    still pay the hit cost (``cache_hit_latency + size * cache_hit_per_byte``
    — the kernel's memcpy out of the cache scales with request size).

    ``direct=True`` is the simulated *direct lane*: preads bypass the
    page-cache model entirely (every read pays real device latency, exactly
    like O_DIRECT skipping the cache) and :attr:`alignment` reports a
    512-byte logical block so aligned leases and the extent coalescer
    engage.  The bandwidth-vs-request-size curve
    (``size / (base_latency + size * per_byte)``) is then fully exposed:
    1 KiB requests crawl at ~17 MB/s on the NVMe profile while 1 MiB
    super-reads stream at ~800 MB/s per channel.
    """

    def __init__(
        self,
        inner: Optional[Device] = None,
        profile: DeviceProfile = DeviceProfile(),
        cache_bytes: int = 0,
        direct: bool = False,
    ):
        self.inner = inner if inner is not None else OSDevice()
        self.profile = profile
        self.stats = DeviceStats()
        self._channels = threading.Semaphore(profile.channels)
        self.direct = direct
        self.alignment = 512 if direct else 0
        self.cache = (_PageCacheModel(cache_bytes)
                      if cache_bytes > 0 and not direct else None)
        self._fd_paths: Dict[int, str] = {}
        self._fd_lock = threading.Lock()

    def _service(self, nbytes: int, metadata: bool = False) -> None:
        p = self.profile
        dur = p.metadata_latency if metadata else p.base_latency + nbytes * p.per_byte
        with self._channels:
            _precise_sleep(dur)

    def _hit(self, nbytes: int) -> None:
        """Page-cache hit service: no device channel occupied, but the
        kernel's copy-out is charged per byte — the curve pinned by
        tests/test_device_model.py."""
        p = self.profile
        _precise_sleep(p.cache_hit_latency + nbytes * p.cache_hit_per_byte)

    def charge_crossing(self) -> None:
        self.stats.crossing()
        _precise_sleep(self.profile.crossing_cost)

    def _path_of(self, fd: int) -> str:
        with self._fd_lock:
            return self._fd_paths.get(fd, f"<fd:{fd}>")

    def open(self, path: str, flags: str = "r") -> int:
        self.stats.op_begin()
        try:
            self._service(0, metadata=True)
            fd = self.inner.open(path, flags)
            with self._fd_lock:
                self._fd_paths[fd] = path
            return fd
        finally:
            self.stats.op_end()

    def close(self, fd: int) -> None:
        self.stats.op_begin()
        try:
            with self._fd_lock:
                self._fd_paths.pop(fd, None)
            return self.inner.close(fd)
        finally:
            self.stats.op_end()

    def pread(self, fd: int, size: int, offset: int) -> bytes:
        self.stats.op_begin()
        try:
            cached = self.cache is not None and self.cache.access(
                self._path_of(fd), offset, size
            )
            if cached:
                self._hit(size)
            else:
                self._service(size)
            return self.inner.pread(fd, size, offset)
        finally:
            self.stats.op_end(read_bytes=size)

    def pread_into(self, fd: int, buf, offset: int) -> int:
        self.stats.op_begin()
        try:
            cached = self.cache is not None and self.cache.access(
                self._path_of(fd), offset, len(buf)
            )
            if cached:
                self._hit(len(buf))
            else:
                self._service(len(buf))
            return self.inner.pread_into(fd, buf, offset)
        finally:
            self.stats.op_end(read_bytes=len(buf))

    def pwrite(self, fd: int, data: bytes, offset: int) -> int:
        self.stats.op_begin()
        try:
            if self.cache is not None:
                self.cache.access(self._path_of(fd), offset, len(data))
            self._service(len(data))
            return self.inner.pwrite(fd, data, offset)
        finally:
            self.stats.op_end(write_bytes=len(data))

    def fstatat(self, path: str) -> os.stat_result:
        self.stats.op_begin()
        try:
            self._service(0, metadata=True)
            return self.inner.fstatat(path)
        finally:
            self.stats.op_end()

    def getdents(self, path: str) -> List[str]:
        self.stats.op_begin()
        try:
            self._service(0, metadata=True)
            return self.inner.getdents(path)
        finally:
            self.stats.op_end()

    def fsync(self, fd: int) -> None:
        self.stats.op_begin()
        try:
            self._service(0, metadata=True)
            return self.inner.fsync(fd)
        finally:
            self.stats.op_end()

    def rename(self, src: str, dst: str) -> None:
        self.stats.op_begin()
        try:
            self._service(0, metadata=True)
            self.inner.rename(src, dst)
            with self._fd_lock:
                for fd, p in self._fd_paths.items():
                    if p == src:
                        self._fd_paths[fd] = dst
        finally:
            self.stats.op_end()

    def unlink(self, path: str) -> None:
        self.stats.op_begin()
        try:
            self._service(0, metadata=True)
            self.inner.unlink(path)
        finally:
            self.stats.op_end()

    def truncate(self, fd: int, size: int) -> None:
        self.stats.op_begin()
        try:
            self._service(0, metadata=True)
            self.inner.truncate(fd, size)
        finally:
            self.stats.op_end()

    def supports_staging(self) -> bool:
        return self.inner.supports_staging()


_SHARD_PREFIX = re.compile(r"^shard(\d+):(.*)$")


class ShardedDevice(Device):
    """N independent sub-devices behind one Device interface.

    Namespace: ``shard{k}:{path}`` pins a path to sub-device ``k``; a bare
    path is routed by a stable hash of the path string, so unprefixed files
    (manifests, commit markers) read back from the same sub-device they were
    written to.  ``getdents`` on a bare path returns the union across all
    sub-devices — a striped directory reads like one directory.

    File descriptors returned by :meth:`open` are *virtual*: sub-devices may
    reuse fd numbers between themselves, so the sharded device allocates its
    own fd space and keeps the (shard, real fd) mapping.  That mapping is also
    how :class:`repro_torch.core.backends.MultiQueueBackend` routes an fd-addressed
    ``IORequest`` to the queue pair owning its target device.

    Stats on this object are the *aggregate* view (e.g. ``max_inflight``
    across all sub-devices — the number to watch when checking that a batch
    really fanned out); per-device counters live on ``devices[i].stats``.
    """

    def __init__(self, devices: Sequence[Device]):
        if not devices:
            raise ValueError("ShardedDevice needs at least one sub-device")
        self.devices: List[Device] = list(devices)
        self.stats = DeviceStats()
        self._vfds: Dict[int, Tuple[int, int]] = {}  # vfd -> (shard, real fd)
        self._next_vfd = 1000
        self._lock = threading.Lock()

    @classmethod
    def simulated(
        cls,
        n: int,
        profile: DeviceProfile = REMOTE_PROFILE,
        cache_bytes: int = 0,
        inner_factory=None,
        direct: bool = False,
    ) -> "ShardedDevice":
        """N :class:`SimulatedDevice` shards, each with its own latency model
        and (by default) its own in-memory backing store."""
        factory = inner_factory if inner_factory is not None else MemDevice
        return cls([
            SimulatedDevice(factory(), profile, cache_bytes=cache_bytes,
                            direct=direct)
            for _ in range(n)
        ])

    # -- namespace ---------------------------------------------------------
    @property
    def num_devices(self) -> int:
        return len(self.devices)

    @property
    def alignment(self) -> int:
        """Strictest sub-device alignment: a lease aligned for the pickiest
        shard is a valid direct-I/O target on every shard."""
        return max(getattr(d, "alignment", 0) for d in self.devices)

    def place(self, path: str, hint: int = 0) -> str:
        return f"shard{hint % len(self.devices)}:{path}"

    def resolve(self, path: str) -> Tuple[int, str]:
        """(shard index, sub-device path) for any path in the namespace."""
        m = _SHARD_PREFIX.match(path)
        if m:
            idx = int(m.group(1))
            if idx >= len(self.devices):
                raise FileNotFoundError(f"no shard {idx}: {path!r}")
            return idx, m.group(2)
        return zlib.crc32(path.encode()) % len(self.devices), path

    def shard_of_fd(self, fd: int) -> int:
        with self._lock:
            if fd not in self._vfds:
                raise OSError(f"bad virtual fd {fd}")
            return self._vfds[fd][0]

    def route(self, sc, args) -> int:
        """Shard index an IORequest targets — the MultiQueueBackend's
        queue-selection function.  Path-addressed syscalls resolve the
        namespace; fd-addressed ones look up the virtual fd."""
        from .syscalls import Sys  # local import: avoid a module cycle

        if sc in (Sys.OPEN, Sys.FSTATAT, Sys.GETDENTS, Sys.UNLINK, Sys.RENAME):
            return self.resolve(args[0])[0]
        return self.shard_of_fd(args[0])

    def _lookup(self, fd: int) -> Tuple[Device, int]:
        with self._lock:
            if fd not in self._vfds:
                raise OSError(f"bad virtual fd {fd}")
            shard, rfd = self._vfds[fd]
        return self.devices[shard], rfd

    # -- Device interface --------------------------------------------------
    def open(self, path: str, flags: str = "r") -> int:
        shard, sub = self.resolve(path)
        self.stats.op_begin()
        try:
            rfd = self.devices[shard].open(sub, flags)
        finally:
            self.stats.op_end()
        with self._lock:
            vfd = self._next_vfd
            self._next_vfd += 1
            self._vfds[vfd] = (shard, rfd)
        return vfd

    def close(self, fd: int) -> None:
        dev, rfd = self._lookup(fd)
        self.stats.op_begin()
        try:
            dev.close(rfd)
        finally:
            self.stats.op_end()
        with self._lock:
            self._vfds.pop(fd, None)

    def pread(self, fd: int, size: int, offset: int) -> bytes:
        dev, rfd = self._lookup(fd)
        self.stats.op_begin()
        try:
            return dev.pread(rfd, size, offset)
        finally:
            self.stats.op_end(read_bytes=size)

    def pread_into(self, fd: int, buf, offset: int) -> int:
        dev, rfd = self._lookup(fd)
        self.stats.op_begin()
        try:
            return dev.pread_into(rfd, buf, offset)
        finally:
            self.stats.op_end(read_bytes=len(buf))

    def pwrite(self, fd: int, data: bytes, offset: int) -> int:
        dev, rfd = self._lookup(fd)
        self.stats.op_begin()
        try:
            return dev.pwrite(rfd, data, offset)
        finally:
            self.stats.op_end(write_bytes=len(data))

    def fstatat(self, path: str) -> os.stat_result:
        shard, sub = self.resolve(path)
        self.stats.op_begin()
        try:
            return self.devices[shard].fstatat(sub)
        finally:
            self.stats.op_end()

    def getdents(self, path: str) -> List[str]:
        m = _SHARD_PREFIX.match(path)
        self.stats.op_begin()
        try:
            if m:
                shard, sub = self.resolve(path)
                return self.devices[shard].getdents(sub)
            # bare path: union across all sub-devices (striped directory)
            names: set = set()
            errors = 0
            for dev in self.devices:
                try:
                    names.update(dev.getdents(path))
                except FileNotFoundError:
                    errors += 1
            if errors == len(self.devices):
                raise FileNotFoundError(path)
            return sorted(names)
        finally:
            self.stats.op_end()

    def fsync(self, fd: int) -> None:
        dev, rfd = self._lookup(fd)
        self.stats.op_begin()
        try:
            dev.fsync(rfd)
        finally:
            self.stats.op_end()

    def rename(self, src: str, dst: str) -> None:
        """Same-shard renames are the atomic fast path (the staging layer
        derives staged names so src and dst co-locate); cross-shard renames
        degrade to copy + unlink, which is not atomic — callers that need
        publish atomicity must keep staged and final names on one shard."""
        s_shard, s_sub = self.resolve(src)
        d_shard, d_sub = self.resolve(dst)
        self.stats.op_begin()
        try:
            if s_shard == d_shard:
                self.devices[s_shard].rename(s_sub, d_sub)
                return
            size = self.devices[s_shard].fstatat(s_sub).st_size
            sfd = self.devices[s_shard].open(s_sub, "r")
            dfd = self.devices[d_shard].open(d_sub, "w")
            try:
                data = self.devices[s_shard].pread(sfd, size, 0)
                self.devices[d_shard].pwrite(dfd, data, 0)
            finally:
                self.devices[s_shard].close(sfd)
                self.devices[d_shard].close(dfd)
            self.devices[s_shard].unlink(s_sub)
        finally:
            self.stats.op_end()

    def unlink(self, path: str) -> None:
        """Pinned (``shard{k}:``) paths unlink exactly there.  A bare path
        first tries its hash route, then falls back to every sub-device —
        the union view, mirroring ``getdents``: pinned creations (shard
        files, staged extents) live where ``place()`` put them, not where
        the hash of their bare name points, and callers sweeping a
        directory by its ``getdents`` listing address them bare."""
        pinned = _SHARD_PREFIX.match(path) is not None
        shard, sub = self.resolve(path)
        self.stats.op_begin()
        try:
            try:
                self.devices[shard].unlink(sub)
                return
            except FileNotFoundError:
                if pinned:
                    raise
            found = False
            for i, d in enumerate(self.devices):
                if i == shard:
                    continue
                try:
                    d.unlink(sub)
                    found = True
                except FileNotFoundError:
                    pass
            if not found:
                raise FileNotFoundError(path)
        finally:
            self.stats.op_end()

    def truncate(self, fd: int, size: int) -> None:
        dev, rfd = self._lookup(fd)
        self.stats.op_begin()
        try:
            dev.truncate(rfd, size)
        finally:
            self.stats.op_end()

    def supports_staging(self) -> bool:
        return all(d.supports_staging() for d in self.devices)

    def charge_crossing(self) -> None:
        # A single-queue caller crosses into "the kernel" once; attribute the
        # cost to sub-device 0 (representative) and count it at the aggregate.
        self.stats.crossing()
        self.devices[0].charge_crossing()

    def sub_snapshots(self) -> List[dict]:
        return [d.stats.snapshot() for d in self.devices]


class MemDevice(Device):
    """In-memory device for fast unit tests (no host FS, no latency)."""

    def __init__(self) -> None:
        self.stats = DeviceStats()
        self._files: Dict[str, bytearray] = {}
        self._fds: Dict[int, str] = {}
        self._next_fd = 100
        self._lock = threading.Lock()

    def open(self, path: str, flags: str = "r") -> int:
        self.stats.op_begin()
        try:
            with self._lock:
                if flags in ("w",):
                    self._files[path] = bytearray()
                elif path not in self._files:
                    if flags == "r":
                        raise FileNotFoundError(path)
                    self._files[path] = bytearray()
                fd = self._next_fd
                self._next_fd += 1
                self._fds[fd] = path
                return fd
        finally:
            self.stats.op_end()

    def close(self, fd: int) -> None:
        self.stats.op_begin()
        try:
            with self._lock:
                self._fds.pop(fd, None)
        finally:
            self.stats.op_end()

    def pread(self, fd: int, size: int, offset: int) -> bytes:
        self.stats.op_begin()
        try:
            with self._lock:
                buf = self._files[self._fds[fd]]
                return bytes(buf[offset : offset + size])
        finally:
            self.stats.op_end(read_bytes=size)

    def pread_into(self, fd: int, buf, offset: int) -> int:
        self.stats.op_begin()
        try:
            with self._lock:
                backing = self._files[self._fds[fd]]
                end = min(len(backing), offset + len(buf))
                n = max(0, end - offset)
                if n:
                    # one copy backing -> registered buffer, no intermediate
                    # bytearray slice + bytes() pair like pread() pays
                    mv = memoryview(backing)
                    try:
                        buf[:n] = mv[offset:end]
                    finally:
                        mv.release()
                return n
        finally:
            self.stats.op_end(read_bytes=len(buf))

    def pwrite(self, fd: int, data: bytes, offset: int) -> int:
        self.stats.op_begin()
        try:
            with self._lock:
                buf = self._files[self._fds[fd]]
                if len(buf) < offset + len(data):
                    buf.extend(b"\x00" * (offset + len(data) - len(buf)))
                buf[offset : offset + len(data)] = data
                return len(data)
        finally:
            self.stats.op_end(write_bytes=len(data))

    def fstatat(self, path: str):
        self.stats.op_begin()
        try:
            with self._lock:
                if path not in self._files:
                    raise FileNotFoundError(path)
                size = len(self._files[path])

            class _Stat:
                st_size = size
                st_mode = 0o100644

            return _Stat()
        finally:
            self.stats.op_end()

    def getdents(self, path: str) -> List[str]:
        self.stats.op_begin()
        try:
            prefix = path.rstrip("/") + "/"
            with self._lock:
                names = {p[len(prefix) :].split("/")[0] for p in self._files if p.startswith(prefix)}
            return sorted(names)
        finally:
            self.stats.op_end()

    def fsync(self, fd: int) -> None:
        self.stats.op_begin()
        self.stats.op_end()

    def rename(self, src: str, dst: str) -> None:
        self.stats.op_begin()
        try:
            with self._lock:
                if src not in self._files:
                    raise FileNotFoundError(src)
                self._files[dst] = self._files.pop(src)
                # open fds follow the file to its new name (inode semantics)
                for fd, p in self._fds.items():
                    if p == src:
                        self._fds[fd] = dst
        finally:
            self.stats.op_end()

    def unlink(self, path: str) -> None:
        self.stats.op_begin()
        try:
            with self._lock:
                if path not in self._files:
                    raise FileNotFoundError(path)
                del self._files[path]
        finally:
            self.stats.op_end()

    def truncate(self, fd: int, size: int) -> None:
        self.stats.op_begin()
        try:
            with self._lock:
                buf = self._files[self._fds[fd]]
                del buf[size:]
        finally:
            self.stats.op_end()

    def supports_staging(self) -> bool:
        return True
