"""Reusable foreaction-graph patterns.

The paper's case-study graphs (Fig. 4) reduce to a handful of loop shapes.
The framework's own substrates (data pipeline, checkpointing) instantiate
these generic builders instead of hand-drawing a graph per call site:

* ``build_stat_list_graph``     — fstatat over a path list (du shape, Fig. 4a)
* ``build_open_list_graph``     — read-only open over a path list (pure, so
  pre-issuable even across weak edges; fans shard-file opens across devices)
* ``build_pread_extents_graph`` — pread over (fd, size, offset) extents
* ``build_pwrite_extents_graph``— pwrite over (fd, data|thunk, offset) extents
  (guaranteed writes: strong edges throughout)
* ``build_copy_extents_graph``  — Link'ed pread->pwrite pairs (cp shape, Fig. 4b)
* ``build_write_file_graph``    — create + pwrite loop + fsync + close: the
  whole-file write chain, speculable end to end because the create is
  *undoable* (it lands in a staging extent and publishes at the close
  barrier — repro_torch.store.staging); fsync/close are harvest-gated so the
  barrier never runs ahead of the writes it orders
* ``build_unlink_list_graph`` — unlink over a path list (all-strong, so the
  barrier unlinks batch once entered; the checkpoint GC sweep's shape)

ctx conventions are documented per builder.  Results are harvested into
ctx lists so wrapped functions can also consume them if desired.

Cross-references: docs/ARCHITECTURE.md ("Reusable graph patterns"); the loop
shapes here are the ones the sharded substrate's consumers (checkpoint
manager, data pipeline) fan out across devices.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .graph import ForeactionGraph, FromNode, GraphBuilder
from .syscalls import Sys


def build_stat_list_graph(name: str = "stat_list") -> ForeactionGraph:
    """ctx: {"paths": [str]}; harvests into ctx["stats"] (dict e -> stat)."""
    b = GraphBuilder(name)

    def args(ctx, ep):
        paths = ctx["paths"]
        return ((paths[ep[0]],), False) if ep[0] < len(paths) else None

    def save(ctx, ep, rc):
        ctx.setdefault("stats", {})[ep[0]] = rc

    def head(ctx, ep):
        return 0 if len(ctx["paths"]) > 0 else 1

    def more(ctx, ep):
        return 0 if ep[0] + 1 < len(ctx["paths"]) else 1

    b.AddBranchingNode("any", head)
    b.AddSyscallNode("fstat", Sys.FSTATAT, args, save)
    b.AddBranchingNode("more", more)
    b.SetStart("any")
    b.BranchAppendChild("any", "fstat")
    b.BranchAppendChild("any", None)
    b.SyscallSetNext("fstat", "more")
    b.BranchAppendChild("more", "fstat", loopback=True)
    b.BranchAppendChild("more", None)
    return b.Build()


def build_open_list_graph(name: str = "open_list") -> ForeactionGraph:
    """ctx: {"paths": [str]}; read-only opens, harvested into ctx["fds"]
    (dict epoch -> fd).  open(path, "r") is pure (cancellable via close), so
    the whole list pre-issues in one batch — on a sharded device the opens
    land on their owning sub-devices concurrently."""
    b = GraphBuilder(name)

    def args(ctx, ep):
        paths = ctx["paths"]
        return ((paths[ep[0]], "r"), False) if ep[0] < len(paths) else None

    def save(ctx, ep, rc):
        ctx.setdefault("fds", {})[ep[0]] = rc

    def head(ctx, ep):
        return 0 if len(ctx["paths"]) > 0 else 1

    def more(ctx, ep):
        return 0 if ep[0] + 1 < len(ctx["paths"]) else 1

    b.AddBranchingNode("any", head)
    b.AddSyscallNode("open", Sys.OPEN, args, save)
    b.AddBranchingNode("more", more)
    b.SetStart("any")
    b.BranchAppendChild("any", "open")
    b.BranchAppendChild("any", None)
    b.SyscallSetNext("open", "more")
    b.BranchAppendChild("more", "open", loopback=True)
    b.BranchAppendChild("more", None)
    return b.Build()


def build_pread_extents_graph(name: str = "pread_extents",
                              weak: bool = False) -> ForeactionGraph:
    """ctx: {"extents": [(fd, size, offset)]}; pure read loop.

    ``weak=True`` marks the loop's closing edge weak — the LSM-get shape
    where the caller may return early after any read (still safe to
    pre-issue: reads are pure)."""
    b = GraphBuilder(name)

    def args(ctx, ep):
        ext = ctx["extents"]
        return ((tuple(ext[ep[0]])), False) if ep[0] < len(ext) else None

    def head(ctx, ep):
        return 0 if len(ctx["extents"]) > 0 else 1

    def more(ctx, ep):
        return 0 if ep[0] + 1 < len(ctx["extents"]) else 1

    b.AddBranchingNode("any", head)
    b.AddSyscallNode("pread", Sys.PREAD, args)
    b.AddBranchingNode("more", more)
    b.SetStart("any")
    b.BranchAppendChild("any", "pread")
    b.BranchAppendChild("any", None)
    b.SyscallSetNext("pread", "more", weak=weak)
    b.BranchAppendChild("more", "pread", loopback=True)
    b.BranchAppendChild("more", None)
    return b.Build()


def build_pwrite_extents_graph(name: str = "pwrite_extents") -> ForeactionGraph:
    """ctx: {"writes": [(fd, data|()->data, offset)]}; guaranteed writes.

    ``data`` may be a zero-arg thunk — the Compute annotation materializes
    the bytes at pre-issue time (computation pulled ahead of the frontier,
    §3.2 'any necessary computation required to produce argument values')."""
    b = GraphBuilder(name)

    def args(ctx, ep):
        ws = ctx["writes"]
        if ep[0] >= len(ws):
            return None
        fd, data, off = ws[ep[0]]
        if callable(data):
            data = data()
        return ((fd, data, off), False)

    def head(ctx, ep):
        return 0 if len(ctx["writes"]) > 0 else 1

    def more(ctx, ep):
        return 0 if ep[0] + 1 < len(ctx["writes"]) else 1

    b.AddBranchingNode("any", head)
    b.AddSyscallNode("pwrite", Sys.PWRITE, args)
    b.AddBranchingNode("more", more)
    b.SetStart("any")
    b.BranchAppendChild("any", "pwrite")
    b.BranchAppendChild("any", None)
    b.SyscallSetNext("pwrite", "more")
    b.BranchAppendChild("more", "pwrite", loopback=True)
    b.BranchAppendChild("more", None)
    return b.Build()


def build_write_file_graph(name: str = "write_file") -> ForeactionGraph:
    """ctx: {"path": str, "writes": [(data|()->data, offset)]}.

    One whole-file write chain: ``open(path, "w")`` -> pwrite loop ->
    fsync -> close.  The open's fd is harvested into ``ctx["fd"]``; each
    write may carry a zero-arg thunk so serialization is pulled ahead of
    the frontier.  fsync is not ready until every write is harvested and
    close not until the fsync is — the mined-graph *harvest barrier* idiom
    — so the teardown pair can never overtake the data it orders.  With a
    staging transaction active the create is undoable: the file appears in
    the committed namespace only at the close (publish) barrier.
    """
    b = GraphBuilder(name)

    def open_args(ctx, ep):
        return ((ctx["path"], "w"), False)

    def open_save(ctx, ep, rc):
        ctx["fd"] = rc

    def wargs(ctx, ep):
        ws = ctx["writes"]
        if "fd" not in ctx or ep[0] >= len(ws):
            return None
        data, off = ws[ep[0]]
        if callable(data):
            data = data()
        return ((ctx["fd"], data, off), False)

    def wsave(ctx, ep, rc):
        ctx["_wf_done"] = ctx.get("_wf_done", 0) + 1

    def sync_args(ctx, ep):
        if ctx.get("_wf_done", 0) < len(ctx["writes"]) or "fd" not in ctx:
            return None  # harvest barrier: all writes first
        return ((ctx["fd"],), False)

    def sync_save(ctx, ep, rc):
        ctx["_wf_synced"] = True

    def close_args(ctx, ep):
        if not ctx.get("_wf_synced"):
            return None
        return ((ctx["fd"],), False)

    def head(ctx, ep):
        return 0 if len(ctx["writes"]) > 0 else 1

    def more(ctx, ep):
        return 0 if ep[0] + 1 < len(ctx["writes"]) else 1

    b.AddSyscallNode("open", Sys.OPEN, open_args, open_save)
    b.AddBranchingNode("any", head)
    b.AddSyscallNode("pwrite", Sys.PWRITE, wargs, wsave)
    b.AddBranchingNode("more", more)
    b.AddSyscallNode("fsync", Sys.FSYNC, sync_args, sync_save)
    b.AddSyscallNode("close", Sys.CLOSE, close_args)
    b.SetStart("open")
    b.SyscallSetNext("open", "any")
    b.BranchAppendChild("any", "pwrite")
    b.BranchAppendChild("any", "fsync")
    b.SyscallSetNext("pwrite", "more")
    b.BranchAppendChild("more", "pwrite", loopback=True)
    b.BranchAppendChild("more", "fsync")
    b.SyscallSetNext("fsync", "close")
    b.SyscallSetNext("close", None)
    return b.Build()


def build_copy_extents_graph(name: str = "copy_extents") -> ForeactionGraph:
    """ctx: {"pairs": [(src_fd, dst_fd, size, offset)]}; each iteration is a
    Link'ed pread->pwrite — the write consumes the read's internal buffer
    with no intermediate copy (Fig. 4b)."""
    b = GraphBuilder(name)

    def rargs(ctx, ep):
        ps = ctx["pairs"]
        if ep[0] >= len(ps):
            return None
        sfd, _dfd, size, off = ps[ep[0]]
        return ((sfd, size, off), True)  # Link with the following pwrite

    def wargs(ctx, ep):
        ps = ctx["pairs"]
        if ep[0] >= len(ps):
            return None
        _sfd, dfd, _size, off = ps[ep[0]]
        return ((dfd, FromNode("pread"), off), False)

    def head(ctx, ep):
        return 0 if len(ctx["pairs"]) > 0 else 1

    def more(ctx, ep):
        return 0 if ep[0] + 1 < len(ctx["pairs"]) else 1

    b.AddBranchingNode("any", head)
    b.AddSyscallNode("pread", Sys.PREAD, rargs)
    b.AddSyscallNode("pwrite", Sys.PWRITE, wargs)
    b.AddBranchingNode("more", more)
    b.SetStart("any")
    b.BranchAppendChild("any", "pread")
    b.BranchAppendChild("any", None)
    b.SyscallSetNext("pread", "pwrite")
    b.SyscallSetNext("pwrite", "more")
    b.BranchAppendChild("more", "pread", loopback=True)
    b.BranchAppendChild("more", None)
    return b.Build()


def build_unlink_list_graph(name: str = "unlink_list") -> ForeactionGraph:
    """ctx: {"victims": [str]}; unlink loop over a path list.

    Unlinks are barriers (the removed bytes are unrecoverable), but all
    edges here are strong, so once the loop starts the whole remainder is
    guaranteed and pre-issues as one batch — on a sharded device the
    unlinks fan out to their owning sub-devices.  Callers must order any
    de-commit step (tombstone rename) *before* activating this graph; the
    checkpoint manager's GC sweep is the canonical user."""
    b = GraphBuilder(name)

    def args(ctx, ep):
        vs = ctx["victims"]
        return ((vs[ep[0]],), False) if ep[0] < len(vs) else None

    def head(ctx, ep):
        return 0 if len(ctx["victims"]) > 0 else 1

    def more(ctx, ep):
        return 0 if ep[0] + 1 < len(ctx["victims"]) else 1

    b.AddBranchingNode("any", head)
    b.AddSyscallNode("unlink", Sys.UNLINK, args)
    b.AddBranchingNode("more", more)
    b.SetStart("any")
    b.BranchAppendChild("any", "unlink")
    b.BranchAppendChild("any", None)
    b.SyscallSetNext("unlink", "more")
    b.BranchAppendChild("more", "unlink", loopback=True)
    b.BranchAppendChild("more", None)
    return b.Build()


PATTERNS: Dict[str, Callable[[], ForeactionGraph]] = {
    "stat_list": build_stat_list_graph,
    "open_list": build_open_list_graph,
    "pread_extents": build_pread_extents_graph,
    "pwrite_extents": build_pwrite_extents_graph,
    "write_file": build_write_file_graph,
    "copy_extents": build_copy_extents_graph,
    "unlink_list": build_unlink_list_graph,
}


def register_patterns(fa, precompile: bool = False) -> None:
    """Register the reusable patterns on a Foreactor.

    ``precompile=True`` additionally builds each graph and compiles its
    :class:`repro_torch.core.plan.GraphPlan` now, so the first wrapped call pays
    a cache probe instead of build+lower — consumers with latency-sensitive
    first calls (the serving loop, the data pipeline's first batch) opt in;
    everyone else keeps the paper's lazy build-on-first-activation."""
    for name, builder in PATTERNS.items():
        fa.register(name, builder)
    if precompile:
        for name in PATTERNS:
            fa.plan(name)
