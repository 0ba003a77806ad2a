"""LSM-tree key-value store (paper §4.3, §6.3 — the LevelDB analogue).

Records live in sorted-table (SSTable) files: a sequence of ~``block_size``
data blocks, an index block mapping first-keys to block extents, and a
footer.  New records go to an in-memory memtable; when full it is dumped as
a new level-0 table (L0 tables may overlap).  When L0 grows past a limit, a
compaction merges it (plus overlapping L1 tables) into non-overlapping L1
tables, and so on down the levels.

``get`` is the paper's measured code path: after a memtable miss it walks
the candidate tables — all covering L0 tables newest-to-oldest, then at
most one table per lower level — doing an in-memory index-block lookup
followed by one data-block ``pread`` per table, returning early on a match.
That pread chain (12~19 deep in the paper's LevelDB) is what the
foreaction graph of Fig. 4(c) parallelizes.

SSTable file layout (little-endian)::

    data blocks:  entries  (u64 key, u32 vlen, value-bytes), sorted by key
    index block:  entries  (u64 first_key, u64 offset, u32 length)
    footer:       'SST1' u64 index_off u32 index_len u32 nblocks
                  u64 min_key u64 max_key u64 nitems
"""

from __future__ import annotations

import json
import struct
import threading
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.core.api import io
from repro_torch.core.device import Device

SST_MAGIC = b"SST1"
_FOOTER = struct.Struct("<4s4xQIIQQQ")
_IDXENT = struct.Struct("<QQI")
_ENT = struct.Struct("<QI")
TOMBSTONE = 0xFFFFFFFF
DEFAULT_BLOCK = 4096


def encode_entries(items: List[Tuple[int, Optional[bytes]]]) -> Tuple[bytes, List[Tuple[int, int, int]]]:
    """Serialize sorted (key, value|None) items into blocks; returns
    (data_bytes, index) with index entries (first_key, offset, length)."""
    out = bytearray()
    index: List[Tuple[int, int, int]] = []
    blk_start = 0
    blk_first: Optional[int] = None
    for k, v in items:
        if blk_first is None:
            blk_first = k
        if v is None:
            out += _ENT.pack(k, TOMBSTONE)
        else:
            out += _ENT.pack(k, len(v)) + v
        if len(out) - blk_start >= DEFAULT_BLOCK_HINT.size:
            index.append((blk_first, blk_start, len(out) - blk_start))
            blk_start = len(out)
            blk_first = None
    if blk_first is not None:
        index.append((blk_first, blk_start, len(out) - blk_start))
    return bytes(out), index


class _BlockHint:
    """Mutable module default so tests can shrink block size."""

    def __init__(self, size: int):
        self.size = size


DEFAULT_BLOCK_HINT = _BlockHint(DEFAULT_BLOCK)


def decode_block(data: bytes) -> Iterator[Tuple[int, Optional[bytes]]]:
    o = 0
    while o + _ENT.size <= len(data):
        k, vlen = _ENT.unpack_from(data, o)
        o += _ENT.size
        if vlen == TOMBSTONE:
            yield k, None
        else:
            yield k, bytes(data[o : o + vlen])
            o += vlen


def search_block(data: bytes, key: int) -> Tuple[bool, Optional[bytes]]:
    """(found, value) — value None + found=True means tombstone."""
    for k, v in decode_block(data):
        if k == key:
            return True, v
        if k > key:
            break
    return False, None


class SSTable:
    def __init__(self, device: Device, path: str):
        self.device = device
        self.path = path
        self.fd: Optional[int] = None
        self.index: List[Tuple[int, int, int]] = []
        self.min_key = 0
        self.max_key = 0
        self.nitems = 0
        self.size_bytes = 0

    @staticmethod
    def build(device: Device, path: str, items: List[Tuple[int, Optional[bytes]]]) -> "SSTable":
        data, index = encode_entries(items)
        idx_bytes = b"".join(_IDXENT.pack(*e) for e in index)
        footer = _FOOTER.pack(SST_MAGIC, len(data), len(idx_bytes), len(index),
                              items[0][0], items[-1][0], len(items))
        fd = io.open(device, path, "w")
        io.pwrite(device, fd, data + idx_bytes + footer, 0)
        io.fsync(device, fd)
        io.close(device, fd)
        t = SSTable(device, path)
        t.open()
        return t

    def open(self) -> "SSTable":
        self.fd = io.open(self.device, self.path, "r")
        st = io.fstatat(self.device, self.path)
        self.size_bytes = st.st_size
        footer = io.pread(self.device, self.fd, _FOOTER.size, st.st_size - _FOOTER.size)
        magic, idx_off, idx_len, nblocks, mn, mx, n = _FOOTER.unpack(footer)
        if magic != SST_MAGIC:
            raise ValueError(f"{self.path}: bad sstable magic")
        raw = io.pread(self.device, self.fd, idx_len, idx_off)
        self.index = [_IDXENT.unpack_from(raw, i * _IDXENT.size) for i in range(nblocks)]
        self.min_key, self.max_key, self.nitems = mn, mx, n
        return self

    def close(self) -> None:
        if self.fd is not None:
            io.close(self.device, self.fd)
            self.fd = None

    def covers(self, key: int) -> bool:
        return self.min_key <= key <= self.max_key

    def block_for(self, key: int) -> Optional[Tuple[int, int]]:
        """In-memory index-block binary search (the Compute annotation of
        the pread_data node, Fig. 4c) -> (offset, length) or None."""
        if not self.covers(key):
            return None
        lo, hi = 0, len(self.index) - 1
        pos = -1
        while lo <= hi:
            mid = (lo + hi) // 2
            if self.index[mid][0] <= key:
                pos = mid
                lo = mid + 1
            else:
                hi = mid - 1
        if pos < 0:
            return None
        _, off, length = self.index[pos]
        return off, length

    def read_block(self, off: int, length: int) -> bytes:
        return io.pread(self.device, self.fd, length, off)

    def iter_all(self) -> Iterator[Tuple[int, Optional[bytes]]]:
        for _, off, length in self.index:
            yield from decode_block(self.read_block(off, length))


class LSMTree:
    """Levels of SSTables + memtable.  ``get`` is the foreactor-target path."""

    MANIFEST = "MANIFEST.json"

    def __init__(
        self,
        device: Device,
        root: str,
        memtable_limit_bytes: int = 1 << 21,  # ~2 MB tables, like LevelDB
        l0_limit: int = 4,
        level_ratio: int = 10,
        fsync_writes: bool = True,
    ):
        self.device = device
        self.root = root.rstrip("/")
        self.memtable_limit = memtable_limit_bytes
        self.l0_limit = l0_limit
        self.level_ratio = level_ratio
        self.fsync_writes = fsync_writes
        self.mem: Dict[int, Optional[bytes]] = {}
        self.mem_bytes = 0
        self.levels: List[List[SSTable]] = [[]]  # levels[0] newest-first
        self._next_file = 0
        self._lock = threading.RLock()

    # -- write path ------------------------------------------------------------
    def put(self, key: int, value: bytes) -> None:
        with self._lock:
            self.mem[key] = value
            self.mem_bytes += 12 + len(value)
            if self.mem_bytes >= self.memtable_limit:
                self.flush()

    def delete(self, key: int) -> None:
        with self._lock:
            self.mem[key] = None
            self.mem_bytes += 12
            if self.mem_bytes >= self.memtable_limit:
                self.flush()

    def _new_path(self) -> str:
        p = f"{self.root}/sst_{self._next_file:06d}.sst"
        self._next_file += 1
        return p

    def flush(self) -> None:
        """Dump the memtable as a new L0 table (newest first)."""
        with self._lock:
            if not self.mem:
                return
            items = sorted(self.mem.items())
            t = SSTable.build(self.device, self._new_path(), items)
            self.levels[0].insert(0, t)
            self.mem = {}
            self.mem_bytes = 0
            if len(self.levels[0]) > self.l0_limit:
                self.compact(0)
            self._write_manifest()

    def compact(self, level: int) -> None:
        """Merge `level` into `level+1` (full-level merge; newest wins)."""
        with self._lock:
            while len(self.levels) <= level + 1:
                self.levels.append([])
            src = self.levels[level]
            dst = self.levels[level + 1]
            merged: Dict[int, Optional[bytes]] = {}
            # oldest first so newer overwrites: dst oldest, then src oldest->newest
            for t in list(reversed(dst)) + list(reversed(src)):
                for k, v in t.iter_all():
                    merged[k] = v
            items = sorted(merged.items())
            # drop tombstones at the bottom level
            if level + 2 >= len(self.levels) or not self.levels[level + 2]:
                items = [(k, v) for k, v in items if v is not None]
            new_tables: List[SSTable] = []
            # split into ~memtable_limit chunks (non-overlapping by construction)
            chunk: List[Tuple[int, Optional[bytes]]] = []
            size = 0
            for k, v in items:
                chunk.append((k, v))
                size += 12 + (len(v) if v else 0)
                if size >= self.memtable_limit * 2:
                    new_tables.append(SSTable.build(self.device, self._new_path(), chunk))
                    chunk, size = [], 0
            if chunk:
                new_tables.append(SSTable.build(self.device, self._new_path(), chunk))
            for t in src + dst:
                t.close()
            self.levels[level] = []
            self.levels[level + 1] = new_tables
            if len(new_tables) > self.level_ratio ** (level + 1):
                self.compact(level + 1)

    def _write_manifest(self) -> None:
        m = {
            "next_file": self._next_file,
            "levels": [[t.path for t in lvl] for lvl in self.levels],
        }
        data = json.dumps(m).encode()
        fd = io.open(self.device, f"{self.root}/{self.MANIFEST}", "w")
        io.pwrite(self.device, fd, data, 0)
        if self.fsync_writes:
            io.fsync(self.device, fd)
        io.close(self.device, fd)

    @classmethod
    def open_existing(cls, device: Device, root: str, **kw) -> "LSMTree":
        """Re-open from MANIFEST (e.g. on a different Device wrapper)."""
        self = cls(device, root, **kw)
        fd = io.open(device, f"{root.rstrip('/')}/{cls.MANIFEST}", "r")
        st = io.fstatat(device, f"{root.rstrip('/')}/{cls.MANIFEST}")
        m = json.loads(io.pread(device, fd, st.st_size, 0))
        io.close(device, fd)
        self._next_file = m["next_file"]
        self.levels = [[SSTable(device, p).open() for p in lvl] for lvl in m["levels"]]
        return self

    # -- read path (the paper's Get) ---------------------------------------------
    def candidates(self, key: int) -> List[Tuple[SSTable, int, int]]:
        """The candidate pread list of Fig. 4(c): every covering L0 table
        newest-to-oldest, then at most one table per lower level; each with
        its data-block extent from the in-memory index lookup."""
        out: List[Tuple[SSTable, int, int]] = []
        with self._lock:
            for t in self.levels[0]:
                blk = t.block_for(key)
                if blk is not None:
                    out.append((t, blk[0], blk[1]))
            for lvl in self.levels[1:]:
                for t in lvl:  # non-overlapping: at most one covers
                    blk = t.block_for(key)
                    if blk is not None:
                        out.append((t, blk[0], blk[1]))
                        break
        return out

    def get(self, key: int) -> Optional[bytes]:
        """Point lookup — memtable, then the candidate pread chain with
        early exit on match (the weak edge of Fig. 4c)."""
        with self._lock:
            if key in self.mem:
                return self.mem[key]
        for t, off, length in self.candidates(key):
            data = io.pread(self.device, t.fd, length, off)
            found, v = search_block(data, key)
            if found:
                return v  # may be None (tombstone) — still an early exit
        return None

    def multi_get(self, keys: List[int]) -> List[Optional[bytes]]:
        """Batched point lookup: N keys, one scatter-gather plan.

        Issue phase: every key's candidate blocks are read through
        ``io.pread_async`` in round-robin order (all first candidates, then
        all second candidates, ...), so under an active ``lsm_multiget``
        session the whole fan-out is in flight before any result is
        demanded.  Harvest barrier: keys resolve in candidate order with the
        usual early exit; futures a key no longer needs are cancelled.  One
        key's read error does not abandon the others — every key is
        harvested first, then the first error (if any) is re-raised.

        Without an active session the futures come back already resolved,
        making this exactly N sequential ``get``\\s — the conformance
        oracle.  The flattened candidate order here must match
        ``repro_torch.store.plugins.capture_lsm_multiget``, which drives the
        generated graph's pread loop over the same extents.
        """
        results: List[Optional[bytes]] = [None] * len(keys)
        per_key: List[List[Tuple[SSTable, int, int]]] = []
        with self._lock:
            from_mem = {i: self.mem[k] for i, k in enumerate(keys)
                        if k in self.mem}
        for i, k in enumerate(keys):
            # memtable hits (tombstones included) take no candidates
            per_key.append([] if i in from_mem else self.candidates(k))
        futs: List[List] = [[None] * len(c) for c in per_key]
        width = max((len(c) for c in per_key), default=0)
        for j in range(width):
            for i, cands in enumerate(per_key):
                if j < len(cands):
                    t, off, length = cands[j]
                    futs[i][j] = io.pread_async(self.device, t.fd,
                                                length, off)
        first_error: Optional[BaseException] = None
        for i, k in enumerate(keys):
            if i in from_mem:
                results[i] = from_mem[i]
                continue
            found_at = len(per_key[i])
            for j in range(len(per_key[i])):
                try:
                    data = futs[i][j].result()
                except BaseException as e:
                    if first_error is None:
                        first_error = e
                    continue  # the other keys must still resolve
                found, v = search_block(data, k)
                if found:
                    results[i] = v
                    found_at = j
                    break
            for j in range(found_at + 1, len(per_key[i])):
                futs[i][j].cancel()  # still-queued tail reads
        if first_error is not None:
            raise first_error
        return results

    # -- misc -------------------------------------------------------------------
    def table_count(self) -> int:
        return sum(len(l) for l in self.levels)

    def close(self) -> None:
        for lvl in self.levels:
            for t in lvl:
                t.close()
