"""On-disk B+-tree with Scan and bulk Load (paper §4.2, Fig. 7).

An *m*-ary balanced search tree of fixed-size pages in one database file.
64-bit integer keys and values; ``degree`` keys per node (max 510 at the
8 KB page size, as in the paper).  Bulk-loading writes key-sorted full
leaves left-to-right (a loop of leaf pwrites); a range scan gathers the
candidate leaf page IDs from the internal levels and then performs a loop
of leaf preads — the two I/O loops Foreactor parallelizes.

Page layout (little-endian)::

    page 0            meta:  'BPT1' u32 degree u32 page_size u64 npages
                             u64 root u32 height u64 nleaves u64 nitems
    pages 1..nleaves  leaves: u8 type=1 u16 nkeys u64 right_sibling
                              keys u64[degree] values u64[degree]
    then internals    nodes:  u8 type=2 u16 nkeys u64 0
                              keys u64[degree] children u64[degree]
                      (keys[i] = max key in subtree of children[i])

Internal pages (a <1% fraction of the file) are cached in memory at
``open()`` — the analogue of LevelDB holding index blocks resident — so
Scan's device I/O is exactly the leaf loop, and point ``search`` on a cold
tree (``search_cold``) demonstrates the strict-dependency-chain limitation
of §7.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.api import io
from repro_torch.core.device import Device

MAGIC = b"BPT1"
PAGE_SIZE = 8192
MAX_DEGREE = 510  # (8192 - 11) // 16 = 511; paper uses 510
_META = struct.Struct("<4sIIQQIQQ")
_NODE_HDR = struct.Struct("<BHQ")
LEAF, INTERNAL = 1, 2


def leaf_page_bytes(
    keys: np.ndarray, vals: np.ndarray, degree: int, leaf_idx: int,
    nleaves: int, page_size: int = PAGE_SIZE,
) -> bytes:
    """Serialize leaf ``leaf_idx`` of a bulk-load from the full sorted
    arrays.  Pure function — shared by the loader and its foreaction-graph
    plugin (the plugin *is* the Compute annotation of the pwrite node)."""
    lo = leaf_idx * degree
    hi = min(lo + degree, len(keys))
    n = hi - lo
    right_sib = leaf_idx + 2 if leaf_idx + 1 < nleaves else 0  # page ids are 1-based
    buf = bytearray(page_size)
    _NODE_HDR.pack_into(buf, 0, LEAF, n, right_sib)
    o = _NODE_HDR.size
    buf[o : o + 8 * n] = np.ascontiguousarray(keys[lo:hi], dtype="<u8").tobytes()
    o += 8 * degree
    buf[o : o + 8 * n] = np.ascontiguousarray(vals[lo:hi], dtype="<u8").tobytes()
    return bytes(buf)


def internal_page_bytes(
    keys: List[int], children: List[int], degree: int, page_size: int = PAGE_SIZE
) -> bytes:
    n = len(keys)
    buf = bytearray(page_size)
    _NODE_HDR.pack_into(buf, 0, INTERNAL, n, 0)
    o = _NODE_HDR.size
    buf[o : o + 8 * n] = np.asarray(keys, dtype="<u8").tobytes()
    o += 8 * degree
    buf[o : o + 8 * n] = np.asarray(children, dtype="<u8").tobytes()
    return bytes(buf)


def parse_node(page: bytes, degree: int):
    typ, n, sib = _NODE_HDR.unpack_from(page, 0)
    o = _NODE_HDR.size
    keys = np.frombuffer(page, dtype="<u8", count=n, offset=o)
    vals = np.frombuffer(page, dtype="<u8", count=n, offset=o + 8 * degree)
    return typ, n, sib, keys, vals


def plan_internal_levels(nleaves: int, degree: int, leaf_max_keys: np.ndarray):
    """Compute the internal levels for a bulk load.  Returns
    (levels, root_page, npages): levels is a list (bottom-up) of lists of
    (page_id, keys, children)."""
    levels = []
    next_page = 1 + nleaves
    child_ids = list(range(1, 1 + nleaves))
    child_max = list(int(k) for k in leaf_max_keys)
    if nleaves == 1:
        return [], 1, 1 + nleaves
    while len(child_ids) > 1:
        level = []
        for i in range(0, len(child_ids), degree):
            ks = child_max[i : i + degree]
            cs = child_ids[i : i + degree]
            level.append((next_page, ks, cs))
            next_page += 1
        levels.append(level)
        child_ids = [pid for pid, _, _ in level]
        child_max = [ks[-1] for _, ks, _ in level]
    root_page = levels[-1][-1][0]
    return levels, root_page, next_page


class BPTree:
    def __init__(self, device: Device, path: str, degree: int = MAX_DEGREE,
                 page_size: int = PAGE_SIZE):
        if not (2 <= degree <= MAX_DEGREE):
            raise ValueError(f"degree must be in [2, {MAX_DEGREE}]")
        self.device = device
        self.path = path
        self.degree = degree
        self.page_size = page_size
        self.fd: Optional[int] = None
        self.npages = 0
        self.root = 0
        self.height = 0
        self.nleaves = 0
        self.nitems = 0
        self._internal_cache: dict = {}

    # -- construction -------------------------------------------------------
    def bulk_load(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Build the tree from a sorted key/value stream.

        The leaf-write loop is THE I/O loop of paper §4.2: page contents are
        deterministic functions of (records, degree, leaf_idx), so a
        foreaction graph can compute future pwrite arguments ahead of time
        and pre-issue them (all edges strong: every write is guaranteed).
        """
        keys = np.asarray(keys, dtype=np.uint64)
        vals = np.asarray(vals, dtype=np.uint64)
        if len(keys) == 0:
            raise ValueError("bulk_load of empty stream")
        if not bool(np.all(keys[:-1] < keys[1:])):
            raise ValueError("bulk_load requires strictly sorted unique keys")
        degree = self.degree
        nleaves = (len(keys) + degree - 1) // degree
        self.fd = io.open(self.device, self.path, "w")
        # --- the leaf pwrite loop (foreactor-parallelizable) ---
        for leaf in range(nleaves):
            page = leaf_page_bytes(keys, vals, degree, leaf, nleaves, self.page_size)
            io.pwrite(self.device, self.fd, page, (1 + leaf) * self.page_size)
        # --- internal levels + meta (small, serial) ---
        leaf_max = keys[np.minimum(np.arange(1, nleaves + 1) * degree, len(keys)) - 1]
        levels, root, npages = plan_internal_levels(nleaves, degree, leaf_max)
        for level in levels:
            for pid, ks, cs in level:
                io.pwrite(self.device, self.fd,
                          internal_page_bytes(ks, cs, degree, self.page_size),
                          pid * self.page_size)
        height = len(levels) + 1
        meta = _META.pack(MAGIC, degree, self.page_size, npages, root, height,
                          nleaves, len(keys))
        io.pwrite(self.device, self.fd, meta, 0)
        io.fsync(self.device, self.fd)
        # the load's fd is write-only on a real file system: reopen the
        # file for reading before the internal pages are read back
        io.close(self.device, self.fd)
        self.fd = io.open(self.device, self.path, "r")
        self.npages, self.root, self.height = npages, root, height
        self.nleaves, self.nitems = nleaves, len(keys)
        self._load_internal_cache()

    # -- opening --------------------------------------------------------------
    def open(self) -> "BPTree":
        self.fd = io.open(self.device, self.path, "r")
        meta = io.pread(self.device, self.fd, _META.size, 0)
        magic, degree, page_size, npages, root, height, nleaves, nitems = _META.unpack(meta)
        if magic != MAGIC:
            raise ValueError("bad B+-tree magic")
        self.degree, self.page_size = degree, page_size
        self.npages, self.root, self.height = npages, root, height
        self.nleaves, self.nitems = nleaves, nitems
        self._load_internal_cache()
        return self

    def _load_internal_cache(self) -> None:
        """Pin internal pages in memory (LevelDB-index-block analogue)."""
        self._internal_cache = {}
        for pid in range(1 + self.nleaves, self.npages):
            page = io.pread(self.device, self.fd, self.page_size, pid * self.page_size)
            self._internal_cache[pid] = parse_node(page, self.degree)

    def close(self) -> None:
        if self.fd is not None:
            io.close(self.device, self.fd)
            self.fd = None

    # -- reading ---------------------------------------------------------------
    def read_leaf(self, leaf_idx: int) -> bytes:
        return io.pread(self.device, self.fd, self.page_size,
                        (1 + leaf_idx) * self.page_size)

    def leaf_range(self, lo: int, hi: int) -> Tuple[int, int]:
        """Candidate leaf indices covering [lo, hi] — derived from the cached
        internal levels ('looking up the last level internal pages and
        gathering all candidate leaf page IDs', §4.2)."""
        first = self._descend_to_leaf(lo)
        last = self._descend_to_leaf(hi)
        return first, last

    def _descend_to_leaf(self, key: int) -> int:
        pid = self.root
        while pid > self.nleaves:  # internal pages come after leaves
            typ, n, _, ks, cs = self._internal_cache[pid]
            i = int(np.searchsorted(ks, key, side="left"))
            if i >= n:
                i = n - 1
            pid = int(cs[i])
        return pid - 1  # leaf page id -> leaf index

    def scan(self, lo: int, hi: int) -> List[Tuple[int, int]]:
        """Range scan [lo, hi] — a loop of leaf preads over the candidate
        leaf range.  THE read loop Foreactor parallelizes (Fig. 7a)."""
        if self.nitems == 0:
            return []
        first, last = self.leaf_range(lo, hi)
        out: List[Tuple[int, int]] = []
        for leaf in range(first, last + 1):
            page = self.read_leaf(leaf)
            typ, n, _sib, ks, vs = parse_node(page, self.degree)
            a = int(np.searchsorted(ks[:n], lo, side="left"))
            b = int(np.searchsorted(ks[:n], hi, side="right"))
            for i in range(a, b):
                out.append((int(ks[i]), int(vs[i])))
        return out

    def search(self, key: int) -> Optional[int]:
        """Point lookup using the cached internals (1 leaf pread)."""
        if self.nitems == 0:
            return None
        leaf = self._descend_to_leaf(key)
        typ, n, _sib, ks, vs = parse_node(self.read_leaf(leaf), self.degree)
        i = int(np.searchsorted(ks[:n], key, side="left"))
        if i < n and int(ks[i]) == key:
            return int(vs[i])
        return None

    def search_cold(self, key: int) -> Optional[int]:
        """Point lookup reading every page from the device: a strict
        dependency chain of preads — the §7 limitation (not speculatable)."""
        pid = self.root
        while True:
            page = io.pread(self.device, self.fd, self.page_size, pid * self.page_size)
            typ, n, _sib, ks, vs = parse_node(page, self.degree)
            if typ == LEAF:
                i = int(np.searchsorted(ks[:n], key, side="left"))
                if i < n and int(ks[i]) == key:
                    return int(vs[i])
                return None
            i = int(np.searchsorted(ks[:n], key, side="left"))
            if i >= n:
                i = n - 1
            pid = int(vs[i])
