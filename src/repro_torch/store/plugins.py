"""Foreaction-graph plugin files for the case-study applications
(paper §4, Fig. 4; §5.1 'Foreaction Graph as Plugin Code').

Each ``build_*`` function composes a graph with the libforeactor builder
API (AddSyscallNode / AddBranchingNode / SyscallSetNext / BranchAppendChild)
and each ``capture_*`` function is the wrapper that captures the *Input*
annotation variables into the per-invocation ctx.

Stub conventions (paper §5.1):
  ComputeArgs(ctx, epochs) -> None (not ready) | ((args...), link_flag)
  SaveResult(ctx, epochs, rc) -> None
  Choice(ctx, epochs)      -> None (not ready) | child index
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np

from repro_torch.core.graph import ForeactionGraph, FromNode, GraphBuilder
from repro_torch.core.syscalls import Sys

from . import bptree as bpt

# ---------------------------------------------------------------------------
# du: getdents followed by an fstatat loop (Fig. 4a)
# ---------------------------------------------------------------------------


def build_du_graph() -> ForeactionGraph:
    b = GraphBuilder("du")

    def dents_args(ctx, ep):
        return ((ctx["root"],), False)

    def dents_save(ctx, ep, rc):
        ctx["entries"] = rc

    def stat_args(ctx, ep):
        ents = ctx.get("entries")
        if ents is None or ep[0] >= len(ents):
            return None
        return ((f"{ctx['root']}/{ents[ep[0]]}",), False)

    def head_choice(ctx, ep):
        ents = ctx.get("entries")
        if ents is None:
            return None
        return 0 if len(ents) > 0 else 1

    def loop_choice(ctx, ep):
        ents = ctx.get("entries")
        if ents is None:
            return None
        return 0 if ep[0] + 1 < len(ents) else 1

    b.AddSyscallNode("getdents", Sys.GETDENTS, dents_args, dents_save)
    b.AddBranchingNode("any_entries", head_choice)
    b.AddSyscallNode("fstat", Sys.FSTATAT, stat_args)
    b.AddBranchingNode("more_entries", loop_choice)
    b.SyscallSetNext("getdents", "any_entries")
    b.BranchAppendChild("any_entries", "fstat")
    b.BranchAppendChild("any_entries", None)
    b.SyscallSetNext("fstat", "more_entries")
    b.BranchAppendChild("more_entries", "fstat", loopback=True)
    b.BranchAppendChild("more_entries", None)
    return b.Build()


def capture_du(device, root: str) -> Dict[str, Any]:
    return {"root": root}


# ---------------------------------------------------------------------------
# cp: fstat, open src/dst, then a loop of Link'ed pread->pwrite (Fig. 4b).
# The pwrite's data argument is the internal buffer the linked pread
# populates (Harvest of the read does nothing — no extra copies).
# All loop edges are strong: every write is guaranteed, so non-pure
# pre-issuing is allowed (§3.3 'no unrecoverable side effects').
# ---------------------------------------------------------------------------


def build_cp_graph() -> ForeactionGraph:
    b = GraphBuilder("cp")

    def stat_args(ctx, ep):
        return ((ctx["src"],), False)

    def stat_save(ctx, ep, rc):
        ctx["size"] = rc.st_size

    def open_src_args(ctx, ep):
        return ((ctx["src"], "r"), False)

    def open_src_save(ctx, ep, rc):
        ctx["sfd"] = rc

    def open_dst_args(ctx, ep):
        return ((ctx["dst"], "w"), False)

    def open_dst_save(ctx, ep, rc):
        ctx["dfd"] = rc

    def _chunk(ctx, e):
        off = e * ctx["buf_size"]
        n = min(ctx["buf_size"], ctx["size"] - off)
        return off, n

    def read_args(ctx, ep):
        if "sfd" not in ctx or "size" not in ctx:
            return None
        off, n = _chunk(ctx, ep[0])
        if n <= 0:
            return None
        return ((ctx["sfd"], n, off), True)  # link=True: submit with the pwrite

    def write_args(ctx, ep):
        if "dfd" not in ctx or "size" not in ctx:
            return None
        off, n = _chunk(ctx, ep[0])
        if n <= 0:
            return None
        return ((ctx["dfd"], FromNode("pread"), off), False)

    def head_choice(ctx, ep):
        if "size" not in ctx:
            return None
        return 0 if ctx["size"] > 0 else 1

    def loop_choice(ctx, ep):
        if "size" not in ctx:
            return None
        return 0 if (ep[0] + 1) * ctx["buf_size"] < ctx["size"] else 1

    b.AddSyscallNode("fstat_src", Sys.FSTATAT, stat_args, stat_save)
    b.AddSyscallNode("open_src", Sys.OPEN, open_src_args, open_src_save)
    b.AddSyscallNode("open_dst", Sys.OPEN, open_dst_args, open_dst_save)
    b.AddBranchingNode("any_data", head_choice)
    b.AddSyscallNode("pread", Sys.PREAD, read_args)
    b.AddSyscallNode("pwrite", Sys.PWRITE, write_args)
    b.AddBranchingNode("more_data", loop_choice)
    b.SyscallSetNext("fstat_src", "open_src")
    b.SyscallSetNext("open_src", "open_dst")
    b.SyscallSetNext("open_dst", "any_data")
    b.BranchAppendChild("any_data", "pread")
    b.BranchAppendChild("any_data", None)
    b.SyscallSetNext("pread", "pwrite")
    b.SyscallSetNext("pwrite", "more_data")
    b.BranchAppendChild("more_data", "pread", loopback=True)
    b.BranchAppendChild("more_data", None)
    return b.Build()


def capture_cp(device, src: str, dst: str, buf_size: int = 128 * 1024) -> Dict[str, Any]:
    return {"src": src, "dst": dst, "buf_size": buf_size}


# ---------------------------------------------------------------------------
# B+-tree Scan: a pure pread loop over candidate leaf pages (§4.2 — same
# shape as the stat loop, replacing fstatat with pread).
# ---------------------------------------------------------------------------


def build_bptree_scan_graph() -> ForeactionGraph:
    b = GraphBuilder("bptree_scan")

    def read_args(ctx, ep):
        leaf = ctx["first_leaf"] + ep[0]
        if leaf > ctx["last_leaf"]:
            return None
        return ((ctx["fd"], ctx["page_size"], (1 + leaf) * ctx["page_size"]), False)

    def loop_choice(ctx, ep):
        return 0 if ctx["first_leaf"] + ep[0] + 1 <= ctx["last_leaf"] else 1

    b.AddSyscallNode("pread_leaf", Sys.PREAD, read_args)
    b.AddBranchingNode("more_leaves", loop_choice)
    b.SyscallSetNext("pread_leaf", "more_leaves")
    b.BranchAppendChild("more_leaves", "pread_leaf", loopback=True)
    b.BranchAppendChild("more_leaves", None)
    return b.Build()


def capture_bptree_scan(tree: "bpt.BPTree", lo: int, hi: int) -> Dict[str, Any]:
    first, last = tree.leaf_range(lo, hi)
    return {
        "fd": tree.fd,
        "page_size": tree.page_size,
        "first_leaf": first,
        "last_leaf": last,
    }


def scan_with_graph(tree: "bpt.BPTree", lo: int, hi: int):
    """The wrapped application function for Scan (identical logic to
    BPTree.scan; kept standalone so the wrapper can capture leaf_range
    before the loop begins)."""
    return tree.scan(lo, hi)


# ---------------------------------------------------------------------------
# B+-tree bulk Load: open + a loop of leaf pwrites whose page bytes are
# computed ahead of time from the input record stream (§4.2).  Writes are
# guaranteed (strong edges throughout).
# ---------------------------------------------------------------------------


def build_bptree_load_graph() -> ForeactionGraph:
    b = GraphBuilder("bptree_load")

    def open_args(ctx, ep):
        return ((ctx["path"], "w"), False)

    def open_save(ctx, ep, rc):
        ctx["fd"] = rc

    def write_args(ctx, ep):
        if "fd" not in ctx:
            return None
        leaf = ep[0]
        if leaf >= ctx["nleaves"]:
            return None
        # the Compute annotation pulled forward: build the page bytes now
        page = bpt.leaf_page_bytes(
            ctx["keys"], ctx["vals"], ctx["degree"], leaf, ctx["nleaves"],
            ctx["page_size"],
        )
        return ((ctx["fd"], page, (1 + leaf) * ctx["page_size"]), False)

    def loop_choice(ctx, ep):
        return 0 if ep[0] + 1 < ctx["nleaves"] else 1

    b.AddSyscallNode("open_db", Sys.OPEN, open_args, open_save)
    b.AddSyscallNode("pwrite_leaf", Sys.PWRITE, write_args)
    b.AddBranchingNode("more_leaves", loop_choice)
    b.SyscallSetNext("open_db", "pwrite_leaf")
    b.SyscallSetNext("pwrite_leaf", "more_leaves")
    b.BranchAppendChild("more_leaves", "pwrite_leaf", loopback=True)
    b.BranchAppendChild("more_leaves", None)
    return b.Build()


def capture_bptree_load(tree: "bpt.BPTree", keys, vals) -> Dict[str, Any]:
    keys = np.asarray(keys, dtype=np.uint64)
    vals = np.asarray(vals, dtype=np.uint64)
    return {
        "path": tree.path,
        "degree": tree.degree,
        "page_size": tree.page_size,
        "keys": keys,
        "vals": vals,
        "nleaves": (len(keys) + tree.degree - 1) // tree.degree,
    }


def load_with_graph(tree: "bpt.BPTree", keys, vals):
    return tree.bulk_load(keys, vals)


# ---------------------------------------------------------------------------
# LSM-tree Get (Fig. 4c): a chain of pread_data nodes over candidate
# tables; the Compute annotation is the in-memory index-block lookup; the
# edge out of each pread is WEAK (the function may return early on a
# match), so only pure reads may be pre-issued past it — which they are.
# ---------------------------------------------------------------------------


def build_lsm_get_graph() -> ForeactionGraph:
    b = GraphBuilder("lsm_get")

    def read_args(ctx, ep):
        cands = ctx["cands"]
        if ep[0] >= len(cands):
            return None
        _t, off, length = cands[ep[0]]
        return ((_t.fd, length, off), False)

    def head_choice(ctx, ep):
        return 0 if len(ctx["cands"]) > 0 else 1

    def loop_choice(ctx, ep):
        return 0 if ep[0] + 1 < len(ctx["cands"]) else 1

    b.AddBranchingNode("any_cands", head_choice)
    b.AddSyscallNode("pread_data", Sys.PREAD, read_args)
    b.AddBranchingNode("more_cands", loop_choice)
    b.SetStart("any_cands")
    b.BranchAppendChild("any_cands", "pread_data")
    b.BranchAppendChild("any_cands", None)
    # weak edge: Get returns early when the key is found in this block
    b.SyscallSetNext("pread_data", "more_cands", weak=True)
    b.BranchAppendChild("more_cands", "pread_data", loopback=True)
    b.BranchAppendChild("more_cands", None)
    return b.Build()


def capture_lsm_get(lsm, key: int) -> Dict[str, Any]:
    return {"cands": lsm.candidates(key), "key": key}


def build_lsm_multiget_graph() -> ForeactionGraph:
    """N-key scatter-gather Get as ONE generated plan (the futures-style
    analytics shape): the per-key candidate chains of
    ``LSMTree.multi_get`` flattened round-robin — every key's first
    candidate, then every second candidate, ... — into a single pread loop.

    Unlike ``lsm_get`` the loop edge is STRONG: the issue phase reads every
    flattened candidate unconditionally (each is some key's possible home),
    and the per-key early exit moves to the harvest barrier, where a
    resolved key simply cancels the futures it no longer needs.
    """
    b = GraphBuilder("lsm_multiget")

    def read_args(ctx, ep):
        extents = ctx["extents"]
        if ep[0] >= len(extents):
            return None
        fd, length, off = extents[ep[0]]
        return ((fd, length, off), False)

    def head_choice(ctx, ep):
        return 0 if len(ctx["extents"]) > 0 else 1

    def loop_choice(ctx, ep):
        return 0 if ep[0] + 1 < len(ctx["extents"]) else 1

    b.AddBranchingNode("any_exts", head_choice)
    b.AddSyscallNode("pread_data", Sys.PREAD, read_args)
    b.AddBranchingNode("more_exts", loop_choice)
    b.SetStart("any_exts")
    b.BranchAppendChild("any_exts", "pread_data")
    b.BranchAppendChild("any_exts", None)
    b.SyscallSetNext("pread_data", "more_exts")
    b.BranchAppendChild("more_exts", "pread_data", loopback=True)
    b.BranchAppendChild("more_exts", None)
    return b.Build()


def capture_lsm_multiget(lsm, keys) -> Dict[str, Any]:
    """Flatten the batch's candidate extents in the exact order
    ``LSMTree.multi_get`` issues them: round-robin across keys, memtable
    hits (tombstones included) contributing none."""
    with lsm._lock:
        in_mem = {k for k in keys if k in lsm.mem}
    per_key = [([] if k in in_mem else lsm.candidates(k)) for k in keys]
    extents = []
    width = max((len(c) for c in per_key), default=0)
    for j in range(width):
        for cands in per_key:
            if j < len(cands):
                t, off, length = cands[j]
                extents.append((t.fd, length, off))
    return {"extents": extents, "keys": list(keys)}


def register_all(fa, precompile: bool = False) -> None:
    """Register every case-study graph on a Foreactor instance.

    ``precompile=True`` builds each graph and compiles its
    :class:`repro_torch.core.plan.GraphPlan` immediately (cached per graph), so a
    serving process warms the plan cache before the first request instead
    of lowering on the request path."""
    names = ("du", "cp", "bptree_scan", "bptree_load", "lsm_get",
             "lsm_multiget")
    fa.register("du", build_du_graph)
    fa.register("cp", build_cp_graph)
    fa.register("bptree_scan", build_bptree_scan_graph)
    fa.register("bptree_load", build_bptree_load_graph)
    fa.register("lsm_get", build_lsm_get_graph)
    fa.register("lsm_multiget", build_lsm_multiget_graph)
    if precompile:
        for name in names:
            fa.plan(name)


# ---------------------------------------------------------------------------
# Mined counterparts: the same du/cp applications observed and mined instead
# of hand-annotated.  The graphs above are the ground truth the miner is
# cross-checked against (tests/test_trace_mine.py asserts the mined graphs
# produce the same pre-issue schedule); docs/AUTHORING.md renders them, and
# tools/check_doc_refs.py rebuilds them to keep those renderings honest.
# ---------------------------------------------------------------------------


def mine_reference_graphs():
    """Record du/cp traces on a deterministic scratch workload and mine
    them; returns ``{"du": MinedGraph, "cp": MinedGraph}``.

    Deterministic by construction (fixed file set, fixed sizes), so two
    calls yield structurally identical graphs — the property the doc
    checker and the determinism test both lean on.
    """
    from repro_torch.core import Foreactor, MemDevice
    from repro_torch.core.api import io as _io  # noqa: F401  (app code routes via io)

    from .fileutils import cp_file, du_dir

    dev = MemDevice()
    for i in range(5):
        fd = dev.open(f"/dir/f{i}", "w")
        dev.pwrite(fd, bytes([i % 251]) * (32 + 8 * i), 0)
        dev.close(fd)
    for i in range(3):
        fd = dev.open(f"/dir2/g{i}", "w")
        dev.pwrite(fd, bytes([i]) * 16, 0)
        dev.close(fd)
    # cp sources: one even multiple of the buffer, one with a remainder
    for name, size in (("/src_a.bin", 4 * 4096), ("/src_b.bin", 6 * 4096 + 100)):
        fd = dev.open(name, "w")
        dev.pwrite(fd, bytes(range(256)) * (size // 256) + b"\x00" * (size % 256), 0)
        dev.close(fd)

    fa = Foreactor(device=dev, backend="sync")
    du = fa.observe("du_mined", capture_du)(du_dir)
    du(dev, "/dir")
    du(dev, "/dir2")
    cp = fa.observe("cp_mined", lambda device, src, dst, buf_size=4096:
                    capture_cp(device, src, dst, buf_size))(cp_file)
    # train on the remainder-chunk trace (it pins the clamped-residual size
    # provenance); the even-multiple trace is the held-out validation run
    cp(dev, "/src_b.bin", "/dst_b.bin", 4096)
    cp(dev, "/src_a.bin", "/dst_a.bin", 4096)
    mined_du = fa.mine("du_mined", register=False)
    mined_cp = fa.mine("cp_mined", register=False)
    fa.shutdown()
    return {"du": mined_du, "cp": mined_cp}
