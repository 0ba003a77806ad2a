"""Sharded, fault-tolerant checkpoint manager (see package docstring).

Shard *files* were always round-robin striped over leaf chunks; on a
:class:`repro_torch.core.device.ShardedDevice` each shard file is additionally
placed on a distinct sub-device (``Device.place``), so a restore's pre-issued
pread batch fans out across queue pairs and aggregate bandwidth scales with
device count (docs/ARCHITECTURE.md, "Sharded multi-device substrate").
Manifest and commit marker stay in the bare namespace: the sharded device
hash-routes them and merges ``getdents`` across sub-devices, so discovery
(:meth:`CheckpointManager.committed_steps`) is topology-blind.

The save path is one foreaction *write graph* (docs/ARCHITECTURE.md,
"Undoable write speculation"): shard creates are staged (undoable), every
extent pwrite pre-issues with its data thunk serializing leaf *k+1* while
the writes for leaf *k* are in flight, per-shard fsync/close ride behind as
harvest barriers, and the manifest + commit marker chains are gated so the
marker still publishes strictly last.  An aborted save rolls its staged
files back — no partial step ever enters the committed namespace.

The port's trees hold ``torch.Tensor`` leaves, on the card or the CPU; numpy
arrays are taken as well.  The files are the reference package's byte for
byte: the same ``keystr`` leaf names (``bridge.leaf_names``), numpy's dtype
names (``"bfloat16"``, ``"float32"``, ``"int32"``), shapes, extents and
CRCs, so a checkpoint written by either package restores in the other and a
delta save chains onto either's base.  bfloat16 needs no ``ml_dtypes``:
such a leaf leaves as its 16-bit patterns and comes back through a
``uint16`` buffer viewed as ``torch.bfloat16``.  Restores return CPU
tensors.

Write-behind snapshots are real copies: the port's AdamW writes the next
step's values into the state's own buffers, so :meth:`save_async` copies
every leaf into host memory it owns (pinned, reused across saves) before
the next step can write; a device leaf's copy is stream-ordered ahead of
that step, and the writer thread waits on its event.
"""

from __future__ import annotations

import json
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.bridge import leaf_names
from repro_torch.core.api import Foreactor, current_session, io
from repro_torch.core.buffers import BufferPool
from repro_torch.core.coalesce import _pool_alignment
from repro_torch.core.device import Device, ShardedDevice
from repro_torch.core.graph import ForeactionGraph, FromNode, GraphBuilder
from repro_torch.core.patterns import register_patterns
from repro_torch.core.syscalls import Sys
from repro_torch.store.staging import STAGE_TAG
from repro_torch.tree import tree_leaves, tree_unflatten

from .policy import CheckpointPolicy, SaveInfo, chain_of

COMMIT_MARKER = "COMMIT"
MANIFEST = "manifest.json"
#: suffix of a de-committed (mid-GC) commit marker; its presence without an
#: ``ok`` marker flags the directory as collection-in-progress for the sweep
GC_TAG = ".__gc"


class CheckpointError(RuntimeError):
    pass


#: manifest dtype names (numpy's, as the reference writes them) and the
#: torch dtypes they stand for
_TORCH_DTYPES = {
    "bfloat16": torch.bfloat16, "float16": torch.float16,
    "float32": torch.float32, "float64": torch.float64,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}
#: byte alignment of each leaf inside the snapshot buffer
_SNAP_ALIGN = 64


@dataclass
class _HostLeaf:
    """One leaf's bytes in host memory: ``data`` is a flat uint8 array."""
    dtype: str
    shape: Tuple[int, ...]
    data: np.ndarray

    @property
    def nbytes(self) -> int:
        return self.data.nbytes


def _host_view(x: Any) -> _HostLeaf:
    """A host leaf over ``x``'s own bytes (no copy): a CPU tensor or a numpy
    array."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous()
        return _HostLeaf(_DTYPE_NAMES[t.dtype], tuple(t.shape),
                         t.reshape(-1).view(torch.uint8).numpy())
    a = np.ascontiguousarray(x)
    return _HostLeaf(str(a.dtype), tuple(a.shape), a.reshape(-1).view(np.uint8))


class _Snapshot:
    """A tree's leaves on the host, with the events recorded around the
    device-to-host copies (None when every leaf was copied synchronously)."""

    def __init__(self, names: List[str], leaves: List[_HostLeaf],
                 events: Optional[Tuple[Any, Any]] = None):
        self.names = names
        self.leaves = leaves
        self.events = events

    def wait(self) -> None:
        if self.events is not None:
            self.events[1].synchronize()

    def copy_ms(self) -> Optional[float]:
        """Device time of the device-to-host copies, once they are done."""
        return None if self.events is None else self.events[0].elapsed_time(self.events[1])


def _from_bytes(buf: bytearray, dtype: str, shape: Sequence[int]) -> torch.Tensor:
    """A CPU tensor over ``buf`` (no copy) from a manifest's dtype name."""
    if dtype not in _TORCH_DTYPES:
        raise CheckpointError(f"unsupported leaf dtype {dtype!r}")
    if dtype == "bfloat16":
        return torch.from_numpy(
            np.frombuffer(buf, np.uint16).reshape(shape)).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(buf, np.dtype(dtype)).reshape(shape))


@dataclass
class _Extent:
    leaf: int  # leaf index
    leaf_off: int  # offset within the leaf byte stream
    shard: int  # shard file id
    shard_off: int  # offset within the shard file
    length: int


def _plan_extents(nbytes_per_leaf: Sequence[int], num_shards: int,
                  chunk_bytes: int) -> Tuple[List[_Extent], List[int]]:
    """Round-robin chunks of all leaves across shard files."""
    extents: List[_Extent] = []
    shard_sizes = [0] * num_shards
    nxt = 0
    for li, n in enumerate(nbytes_per_leaf):
        off = 0
        while off < n:
            ln = min(chunk_bytes, n - off)
            s = nxt % num_shards
            extents.append(_Extent(li, off, s, shard_sizes[s], ln))
            shard_sizes[s] += ln
            off += ln
            nxt += 1
    return extents, shard_sizes


class _LazyBlobs:
    """Per-leaf serialization on first touch, cached.

    The extent plan needs only ``nbytes`` (known without serializing), so
    serialization runs when a write's data thunk fires at pre-issue time —
    the engine serializes leaf *k+1* on the application thread while the
    workers are still writing leaf *k*'s extents.

    ``arrays`` are flat uint8 arrays (a leaf's bytes).  With a ``pool``,
    serialization lands in *leased aligned buffers* (the WRITE_FIXED
    analogue): each leaf is copied once into a registered slab
    and every extent thunk hands out a zero-copy ``memoryview`` slice of
    it, so the save graph's pwrites write straight out of registered —
    and, on a direct-mode device, O_DIRECT-valid — memory instead of a
    fresh ``tobytes`` allocation per leaf.  The caller releases the slabs
    via :meth:`release` once the save graph has drained; leaves the pool
    declines (over-class or at capacity) are written straight out of
    ``arrays`` through a ``memoryview`` (the reference copies them with
    ``tobytes``): the save owns its snapshot, or its caller holds the tree
    still for the length of a synchronous save.
    """

    def __init__(self, arrays: Sequence[np.ndarray],
                 pool: Optional[BufferPool] = None, alignment: int = 0):
        self.arrays = arrays
        self.pool = pool
        self.alignment = alignment
        self._blobs: Dict[int, Any] = {}
        self._leases: List[Any] = []

    def __getitem__(self, i: int):
        b = self._blobs.get(i)
        if b is None:
            a = self.arrays[i]
            lease = (self.pool.lease(a.nbytes, alignment=self.alignment)
                     if self.pool is not None else None)
            if lease is not None:
                mv = lease.mv[: a.nbytes]
                mv[:] = memoryview(a)
                lease.filled(a.nbytes)
                self._leases.append(lease)
                b = self._blobs[i] = mv
            else:
                b = self._blobs[i] = memoryview(a)
        return b

    def release(self) -> None:
        """Return the leased slabs to the pool.  Must run only after every
        consumer is done with the views (the save session has drained) —
        the slabs recycle immediately."""
        leases, self._leases = self._leases, []
        self._blobs.clear()
        for lease in leases:
            lease.release()

    def __len__(self) -> int:
        return len(self.arrays)


def build_save_graph(num_shards: int, num_extents: int,
                     name: str) -> ForeactionGraph:
    """The full checkpoint-save chain as one foreaction graph.

    Shape depends only on (num_shards, num_extents); which shard each
    extent targets, the data thunks, and the paths come from ctx::

        ctx = {"paths": [shard paths], "writes": [(shard, thunk, off)],
               "per_shard": [extent count per shard],
               "manifest_path": str, "manifest_bytes": ()->bytes,
               "marker_path": str}

    Node order mirrors the serial save exactly: S creating opens, E extent
    pwrites, S fsyncs, S closes, then the manifest chain, then the commit
    marker chain.  All edges are strong (a started save is guaranteed), so
    opens and data writes pre-issue in one sweep — the writes take their fd
    as ``FromNode`` of their shard's open, which is what lets them enter
    the queue before any open completes.  The fsync of shard *s* is
    harvest-gated on shard *s*'s writes and each close on its fsync; the
    marker chain is gated on every shard close plus the manifest close, so
    the commit marker is published strictly last even though everything
    before it overlapped.
    """
    b = GraphBuilder(name)

    def _fd_of(ctx, s: int):
        """This shard's fd: the harvested value once the frontier served the
        open, else a FromNode deferred to the pre-issued open request.  The
        fallback matters at the chain head — the very first open is served
        at the frontier (never pre-issued), so nodes depending on it can
        only bind through ctx."""
        fds = ctx.get("fds", ())
        return fds[s] if s in fds else FromNode(f"open{s}")

    def _open(s: int):
        def args(ctx, ep):
            return ((ctx["paths"][s], "w"), False)

        def save(ctx, ep, rc):
            ctx.setdefault("fds", {})[s] = rc

        return args, save

    def _write(j: int):
        def args(ctx, ep):
            s, thunk, off = ctx["writes"][j]
            return ((_fd_of(ctx, s), thunk(), off), False)

        def save(ctx, ep, rc):
            s, _thunk, _off = ctx["writes"][j]
            done = ctx.setdefault("_w_done", [0] * len(ctx["paths"]))
            done[s] += 1
            ctx["_w_total"] = ctx.get("_w_total", 0) + 1

        return args, save

    def _fsync(s: int):
        def args(ctx, ep):
            done = ctx.get("_w_done", [0] * len(ctx["paths"]))
            if done[s] < ctx["per_shard"][s]:
                return None  # harvest barrier: this shard's writes first
            return ((_fd_of(ctx, s),), False)

        def save(ctx, ep, rc):
            ctx.setdefault("_synced", set()).add(s)

        return args, save

    def _close(s: int):
        def args(ctx, ep):
            if s not in ctx.get("_synced", ()):
                return None
            return ((_fd_of(ctx, s),), False)

        def save(ctx, ep, rc):
            ctx["_closed"] = ctx.get("_closed", 0) + 1

        return args, save

    num = [0]

    def chain(nm, sc, args, save=None):
        b.AddSyscallNode(nm, sc, args, save)
        if num[0]:
            b.SyscallSetNext(prev[0], nm)
        prev[0] = nm
        num[0] += 1

    prev = [None]
    for s in range(num_shards):
        a, sv = _open(s)
        chain(f"open{s}", Sys.OPEN, a, sv)
    for j in range(num_extents):
        a, sv = _write(j)
        chain(f"w{j}", Sys.PWRITE, a, sv)
    for s in range(num_shards):
        a, sv = _fsync(s)
        chain(f"sync{s}", Sys.FSYNC, a, sv)
    for s in range(num_shards):
        a, sv = _close(s)
        chain(f"close{s}", Sys.CLOSE, a, sv)

    # manifest chain: content is ready once every extent write is harvested
    def m_open_args(ctx, ep):
        return ((ctx["manifest_path"], "w"), False)

    def _mfd(ctx):
        return ctx["mfd"] if "mfd" in ctx else FromNode("open_m")

    def _cfd(ctx):
        return ctx["cfd"] if "cfd" in ctx else FromNode("open_c")

    def m_write_args(ctx, ep):
        if ctx.get("_w_total", 0) < len(ctx["writes"]):
            return None
        return ((_mfd(ctx), ctx["manifest_bytes"](), 0), False)

    def m_write_save(ctx, ep, rc):
        ctx["_m_written"] = True

    def m_sync_args(ctx, ep):
        if not ctx.get("_m_written"):
            return None
        return ((_mfd(ctx),), False)

    def m_sync_save(ctx, ep, rc):
        ctx["_m_synced"] = True

    def m_close_args(ctx, ep):
        if not ctx.get("_m_synced"):
            return None
        return ((_mfd(ctx),), False)

    def m_close_save(ctx, ep, rc):
        ctx["_m_closed"] = True

    chain("open_m", Sys.OPEN, m_open_args,
          lambda ctx, ep, rc: ctx.__setitem__("mfd", rc))
    chain("w_m", Sys.PWRITE, m_write_args, m_write_save)
    chain("sync_m", Sys.FSYNC, m_sync_args, m_sync_save)
    chain("close_m", Sys.CLOSE, m_close_args, m_close_save)

    # commit-marker chain: gated on every shard close + the manifest close,
    # so the marker publishes strictly last (the atomic-commit invariant)
    def c_open_args(ctx, ep):
        if ctx.get("_closed", 0) < len(ctx["paths"]) or not ctx.get("_m_closed"):
            return None
        return ((ctx["marker_path"], "w"), False)

    def c_write_args(ctx, ep):
        return ((_cfd(ctx), b"ok", 0), False)

    def c_write_save(ctx, ep, rc):
        ctx["_c_written"] = True

    def c_sync_args(ctx, ep):
        if not ctx.get("_c_written"):
            return None
        return ((_cfd(ctx),), False)

    def c_sync_save(ctx, ep, rc):
        ctx["_c_synced"] = True

    def c_close_args(ctx, ep):
        if not ctx.get("_c_synced"):
            return None
        return ((_cfd(ctx),), False)

    chain("open_c", Sys.OPEN, c_open_args,
          lambda ctx, ep, rc: ctx.__setitem__("cfd", rc))
    chain("w_c", Sys.PWRITE, c_write_args, c_write_save)
    chain("sync_c", Sys.FSYNC, c_sync_args, c_sync_save)
    chain("close_c", Sys.CLOSE, c_close_args)
    b.SyscallSetNext("close_c", None)
    return b.Build()


def build_gc_graph(name: str = "ckpt_gc") -> ForeactionGraph:
    """Collect one superseded checkpoint directory, crash-safely.

    ctx: ``{"marker": str, "tomb": str, "victims": [str]}``.

    Protocol (forward-only; every intermediate state is safe):

    1. ``rename(marker -> tomb)`` — the *tombstone rename*.  Moving the
       commit marker aside atomically de-commits the directory: discovery
       (:meth:`CheckpointManager.committed_steps`) requires the marker at
       its canonical name, so ``restore_latest`` can never pick a directory
       whose files are about to disappear.  The rename is *undoable*
       (:meth:`repro_torch.store.staging.StagingTxn.stage_rename`): an abort
       before the commit point below renames it back and the checkpoint
       stays fully live.
    2. The wrapped function then calls
       :meth:`repro_torch.store.staging.StagingTxn.publish_demanded` — the point
       of no return.  From here the tombstone survives any abort.
    3. Unlink every file, the tombstone last.  Unlinks are barriers and
       gated on the tombstone rename being harvested (``_tomb_done``), so
       speculation can never delete a byte of a still-committed checkpoint;
       past the gate the whole victim list pre-issues as one batch and fans
       out across sub-devices.

    A crash anywhere mid-protocol leaves either a fully live checkpoint
    (before the commit point) or a tombstoned, partially emptied directory
    that discovery skips and the next GC pass sweeps to completion
    (:meth:`CheckpointManager.gc`).
    """
    b = GraphBuilder(name)

    def r_args(ctx, ep):
        return ((ctx["marker"], ctx["tomb"]), False)

    def r_save(ctx, ep, rc):
        ctx["_tomb_done"] = True

    def u_args(ctx, ep):
        if not ctx.get("_tomb_done"):
            return None  # harvest barrier: de-commit before any deletion
        vs = ctx["victims"]
        return ((vs[ep[0]],), False) if ep[0] < len(vs) else None

    def head(ctx, ep):
        return 0 if len(ctx["victims"]) > 0 else 1

    def more(ctx, ep):
        return 0 if ep[0] + 1 < len(ctx["victims"]) else 1

    b.AddSyscallNode("tomb", Sys.RENAME, r_args, r_save)
    b.AddBranchingNode("any", head)
    b.AddSyscallNode("unlink", Sys.UNLINK, u_args)
    b.AddBranchingNode("more", more)
    b.SetStart("tomb")
    b.SyscallSetNext("tomb", "any")
    b.BranchAppendChild("any", "unlink")
    b.BranchAppendChild("any", None)
    b.SyscallSetNext("unlink", "more")
    b.BranchAppendChild("more", "unlink", loopback=True)
    b.BranchAppendChild("more", None)
    return b.Build()


class CheckpointManager:
    """Save/restore trees of tensors (or numpy arrays) under ``root`` on a
    Device.

    Directory layout::

        root/step_{N:010d}/shard_{i:04d}.bin
        root/step_{N:010d}/manifest.json
        root/step_{N:010d}/COMMIT          (written last: atomic commit)
    """

    def __init__(
        self,
        device: Device,
        root: str,
        fa: Optional[Foreactor] = None,
        num_shards: int = 16,
        chunk_bytes: int = 4 << 20,
        keep: int = 3,
        policy: Optional[CheckpointPolicy] = None,
        max_delta_chain: int = 8,
    ):
        self.device = device
        self.root = root.rstrip("/")
        self.num_shards = num_shards
        self.chunk_bytes = chunk_bytes
        #: retention: ``policy`` wins; the legacy ``keep`` int is sugar for
        #: CheckpointPolicy(keep_last=keep)
        self.policy = policy if policy is not None \
            else CheckpointPolicy(keep_last=keep)
        self.keep = self.policy.keep_last
        #: a delta save whose base chain is already this deep falls back to
        #: a full save (restore cost and failure blast radius stay bounded)
        self.max_delta_chain = max_delta_chain
        self.fa = fa if fa is not None else Foreactor(device=device, depth=32)
        #: registered slabs for leaf serialization (the WRITE_FIXED
        #: analogue): save graphs write out of leased aligned buffers
        #: instead of a fresh tobytes() per leaf; alignment follows the
        #: device's direct-I/O block size (0 on buffered devices)
        self.save_pool = BufferPool()
        register_patterns(self.fa)
        self.fa.register("ckpt_gc", build_gc_graph)
        self._async_thread: Optional[threading.Thread] = None
        self._async_error: Optional[BaseException] = None
        # serializes save_async/wait_pending: starting a second background
        # save MUST join-or-raise the first (losing its error or orphaning
        # its thread would silently drop a checkpoint)
        self._async_lock = threading.Lock()
        # highest wall_time ever committed (lazily recovered from on-disk
        # manifests); stored wall times are clamped to >= this floor so a
        # backwards system-clock step between saves cannot produce a
        # non-monotone committed history
        self._wall_floor: Optional[float] = None
        #: host memory that snapshots are copied into (flat uint8, pinned
        #: when a leaf lies on the card), reused across saves: a snapshot
        #: holds it until its save has finished, and every save first
        #: joins the one in flight
        self._snap_buf: Optional[torch.Tensor] = None
        #: one record per committed save: step, mode (``"sync"`` or
        #: ``"async"``), seconds from the call to the commit, tree bytes,
        #: bytes written and the device time of its device-to-host copies
        self.save_log: List[Dict[str, Any]] = []
        #: one record per restore: step, seconds, of which reading the
        #: chain's extents and checking the leaves' CRCs, bytes
        self.restore_log: List[Dict[str, Any]] = []

    # -- paths ----------------------------------------------------------------
    def step_dir(self, step: int) -> str:
        return f"{self.root}/step_{step:010d}"

    def _shard_path(self, step: int, i: int) -> str:
        # place() pins shard file i to sub-device i % N on a ShardedDevice
        # (identity on flat devices), spreading restore/save I/O across
        # every available queue pair.
        return self.device.place(f"{self.step_dir(step)}/shard_{i:04d}.bin", hint=i)

    def _tombstone_path(self, step: int) -> str:
        """The mid-GC name of a step's commit marker.  On a sharded device
        it is pinned to the marker's own sub-device (like staged names are)
        so the tombstone rename stays a single atomic same-shard rename."""
        marker = f"{self.step_dir(step)}/{COMMIT_MARKER}"
        if isinstance(self.device, ShardedDevice):
            shard, sub = self.device.resolve(marker)
            return f"shard{shard}:{sub}{GC_TAG}"
        return marker + GC_TAG

    # -- snapshots --------------------------------------------------------------
    def _snap_buffer(self, nbytes: int, pin: bool) -> torch.Tensor:
        buf = self._snap_buf
        if buf is None or buf.numel() < nbytes or (pin and not buf.is_pinned()):
            self._snap_buf = buf = None  # free the old buffer before the new one
            buf = self._snap_buf = torch.empty(nbytes, dtype=torch.uint8,
                                               pin_memory=pin)
        return buf

    def _snapshot(self, tree: Any, copy: bool) -> _Snapshot:
        """The leaves of ``tree`` on the host, in flatten order.

        Leaves on the card are always copied into the snapshot buffer; with
        ``copy`` the host leaves are too, else they are viewed in place.
        The device-to-host copies are enqueued on the current stream, so
        whatever the caller enqueues next (the next step's in-place
        updates) runs after them; :meth:`_Snapshot.wait` waits for them.
        """
        names = leaf_names(tree)
        xs = tree_leaves(tree)
        on_card = [isinstance(x, torch.Tensor) and x.device.type != "cpu" for x in xs]
        offs, total = [], 0
        for x, card in zip(xs, on_card):
            offs.append(total)
            if card or (copy and isinstance(x, torch.Tensor)):
                nb = x.numel() * x.element_size()
                total += -(-nb // _SNAP_ALIGN) * _SNAP_ALIGN
        buf = self._snap_buffer(total, pin=any(on_card))
        leaves: List[_HostLeaf] = []
        events = None
        if any(on_card):
            stream = torch.cuda.current_stream(
                next(x.device for x, card in zip(xs, on_card) if card))
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record(stream)
        for x, card, off in zip(xs, on_card, offs):
            if card or (copy and isinstance(x, torch.Tensor)):
                t = x.detach()
                dst = buf[off : off + t.numel() * t.element_size()]
                dst.view(t.dtype).view(t.shape).copy_(t, non_blocking=card)
                leaves.append(_HostLeaf(_DTYPE_NAMES[t.dtype], tuple(t.shape),
                                        dst.numpy()))
            elif copy:
                leaves.append(_host_view(np.array(x, copy=True)))
            else:
                leaves.append(_host_view(x))
        if events is not None:
            events[1].record(stream)
        return _Snapshot(names, leaves, events)

    def save_in_flight(self) -> bool:
        """True while a write-behind save is still running."""
        th = self._async_thread
        return th is not None and th.is_alive()

    def _log_save(self, step: int, mode: str, t0: float, snap: _Snapshot,
                  written: int) -> None:
        self.save_log.append({
            "step": step, "mode": mode, "seconds": time.perf_counter() - t0,
            "bytes": sum(lf.nbytes for lf in snap.leaves), "written": written,
            "copy_ms": snap.copy_ms()})

    def close(self) -> None:
        """Join a write-behind save still in flight (its error, if any,
        stays for :meth:`wait_pending`) and free the snapshot buffer.  The
        manager stays usable; its next save allocates the buffer again."""
        with self._async_lock:
            if self._async_thread is not None:
                self._async_thread.join()
                self._async_thread = None
            self._snap_buf = None

    # -- save -------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict[str, Any]] = None,
             delta: bool = False) -> None:
        """Write one committed checkpoint step as a single foreaction write
        graph (:func:`build_save_graph`): staged shard creates, pipelined
        leaf serialization, pre-issued extent writes, fsync/close harvest
        barriers, commit marker published strictly last.  Aborting mid-save
        rolls the staged files back — no trace in the committed namespace.

        ``delta=True`` writes an *incremental* checkpoint: every extent of
        the (identically chunked) tree is hashed against the effective
        per-extent CRCs of the newest committed chain, and only changed
        extents are written, packed densely into this step's shard files;
        the manifest records ``base`` so restore can chain.  Falls back to
        a full save when there is no usable base (nothing committed, leaf
        spec changed, chain too deep, or the base predates per-extent
        CRCs).  Each save is followed by a policy-driven GC pass
        (:meth:`gc`).

        A write-behind save still in flight is joined first (its error, if
        any, raised here): leaves on the card are copied into the snapshot
        buffer that save holds.  Host leaves are written in place, so the
        caller leaves them unchanged until this returns.
        """
        t0 = time.perf_counter()
        with self._async_lock:
            self._join_pending_locked()
            snap = self._snapshot(tree, copy=False)
            snap.wait()
            written = self._write(step, snap, extra, delta)
        self._log_save(step, "sync", t0, snap, written)

    def _write(self, step: int, snap: _Snapshot, extra: Optional[Dict[str, Any]],
               delta: bool) -> int:
        """The write graph of :meth:`save` over a host snapshot; returns the
        bytes of extents written."""
        names = snap.names
        arrays = snap.leaves
        blobs = _LazyBlobs([lf.data for lf in arrays], pool=self.save_pool,
                           alignment=_pool_alignment(self.device))
        if step in self.committed_steps():
            # re-saving a committed step (e.g. an emergency save landing on
            # the step a periodic save already wrote) must not overwrite it
            # in place: publish renames land file-by-file, so a crash
            # mid-resave would leave a directory whose stale ``ok`` marker
            # vouches for mixed old/new bytes.  De-commit and collect the
            # old directory first — a crash now leaves an uncommitted
            # partial that discovery skips, and restore falls back to the
            # previous committed step.
            self._collect(step)
        extents, shard_sizes = _plan_extents([a.nbytes for a in arrays],
                                             self.num_shards, self.chunk_bytes)
        base_step: Optional[int] = None
        if delta:
            base_map = self._delta_base(names, arrays)
            if base_map is not None:
                base_step, chain_crcs = base_map
                dsizes = [0] * self.num_shards
                changed: List[Tuple[_Extent, int]] = []
                for e in extents:
                    crc = zlib.crc32(
                        blobs[e.leaf][e.leaf_off : e.leaf_off + e.length])
                    if chain_crcs.get((names[e.leaf], e.leaf_off, e.length)) == crc:
                        continue
                    ne = _Extent(e.leaf, e.leaf_off, e.shard,
                                 dsizes[e.shard], e.length)
                    dsizes[e.shard] += e.length
                    changed.append((ne, crc))
                extents = [e for e, _ in changed]
                shard_sizes = dsizes
                ext_crcs: Optional[List[int]] = [c for _, c in changed]
            else:
                delta = False
        if not delta:
            ext_crcs = None  # full save: extent CRCs computed lazily below
        d = self.step_dir(step)
        paths = [self._shard_path(step, i) for i in range(self.num_shards)]
        per_shard = [0] * self.num_shards
        for e in extents:
            per_shard[e.shard] += 1
        writes: List[Tuple[int, Callable[[], bytes], int]] = [
            (e.shard,
             (lambda e=e: blobs[e.leaf][e.leaf_off : e.leaf_off + e.length]),
             e.shard_off)
            for e in extents
        ]
        manifest_cache: Dict[str, bytes] = {}
        # stamp the wall time eagerly (not inside the lazily-evaluated
        # manifest closure) and clamp it against the committed floor:
        # retention anchoring orders history by wall_time, so a clock that
        # steps backwards must not make a later step look older
        wall_time = max(time.time(), self._wall_time_floor())

        def manifest_bytes() -> bytes:
            data = manifest_cache.get("data")
            if data is None:
                crcs = ext_crcs if ext_crcs is not None else [
                    zlib.crc32(blobs[e.leaf][e.leaf_off : e.leaf_off + e.length])
                    for e in extents
                ]
                manifest = {
                    "step": step,
                    "num_shards": self.num_shards,
                    "shard_sizes": shard_sizes,
                    "wall_time": wall_time,
                    "kind": "delta" if base_step is not None else "full",
                    "base": base_step,
                    "leaves": [
                        {
                            "name": names[i],
                            "dtype": arrays[i].dtype,
                            "shape": list(arrays[i].shape),
                            "nbytes": arrays[i].nbytes,
                            "crc32": zlib.crc32(blobs[i]),
                        }
                        for i in range(len(arrays))
                    ],
                    "extents": [
                        [e.leaf, e.leaf_off, e.shard, e.shard_off, e.length, c]
                        for e, c in zip(extents, crcs)
                    ],
                    "extra": extra or {},
                }
                data = manifest_cache["data"] = json.dumps(manifest).encode()
            return data

        # register is an idempotent builder assignment; the built graph and
        # its compiled plan are cached by name/(graph, depth-mode), so every
        # save after the first of a given shape costs two dict probes
        graph_name = f"ckpt_save_s{self.num_shards}_e{len(extents)}"
        self.fa.register(
            graph_name,
            lambda S=self.num_shards, E=len(extents), n=graph_name:
                build_save_graph(S, E, n))
        self.fa.plan(graph_name)

        def capture():
            return {
                "paths": paths,
                "writes": writes,
                "per_shard": per_shard,
                "manifest_path": f"{d}/{MANIFEST}",
                "manifest_bytes": manifest_bytes,
                "marker_path": f"{d}/{COMMIT_MARKER}",
            }

        @self.fa.wrap(graph_name, capture)
        def _save_all():
            fds = [io.open(self.device, p, "w") for p in paths]
            for s, thunk, off in writes:
                io.pwrite(self.device, fds[s], thunk(), off)
            for fd in fds:
                io.fsync(self.device, fd)
            for fd in fds:
                io.close(self.device, fd)
            mf = io.open(self.device, f"{d}/{MANIFEST}", "w")
            io.pwrite(self.device, mf, manifest_bytes(), 0)
            io.fsync(self.device, mf)
            io.close(self.device, mf)
            # atomic commit: the marker is written (and published) last
            cf = io.open(self.device, f"{d}/{COMMIT_MARKER}", "w")
            io.pwrite(self.device, cf, b"ok", 0)
            io.fsync(self.device, cf)
            io.close(self.device, cf)

        try:
            _save_all()
        finally:
            # the wrapped session has drained (or rolled back): no worker
            # still reads the leased slabs, so they recycle now
            blobs.release()
        self._wall_floor = wall_time
        self.gc()
        return sum(e.length for e in extents)

    def save_async(self, step: int, tree: Any, extra: Optional[Dict[str, Any]] = None,
                   delta: bool = False) -> None:
        """Write-behind checkpointing: snapshot to host memory now, run the
        (speculated) write graph on a background thread, overlap with step
        compute.  Join-or-raise semantics: if a previous background save is
        still running it is joined first, and if it failed its error is
        raised *here* — a second call can never silently orphan an
        in-flight save or swallow its failure.

        The snapshot is a copy of every leaf into host memory the manager
        owns (:meth:`_snapshot`): host leaves are copied before this
        returns, device leaves by copies enqueued ahead of the caller's next
        step, which the background thread waits for.  The caller may write
        into the tree's buffers as soon as this returns."""
        with self._async_lock:
            self._join_pending_locked()
            t0 = time.perf_counter()
            snap = self._snapshot(tree, copy=True)

            def run():
                try:
                    snap.wait()
                    written = self._write(step, snap, extra, delta)
                    self._log_save(step, "async", t0, snap, written)
                except BaseException as e:  # surfaced on next wait_pending()
                    self._async_error = e

            self._async_thread = threading.Thread(
                target=run, name=f"ckpt-save-{step}", daemon=True)
            self._async_thread.start()

    def wait_pending(self) -> None:
        with self._async_lock:
            self._join_pending_locked()

    def _join_pending_locked(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None
        if self._async_error is not None:
            e, self._async_error = self._async_error, None
            raise CheckpointError(f"async checkpoint save failed: {e!r}") from e

    # -- discovery / validation ---------------------------------------------------
    def committed_steps(self) -> List[int]:
        """Steps with a readable ``ok`` commit marker, sorted ascending.

        Everything else is skipped, never raised on: directories without a
        marker (a killed save's partial output, or a mid-GC directory whose
        marker was renamed to its tombstone), markers with other content
        (legacy ``gc`` tombstones), entries that do not parse as a step
        number (staged debris), and per-entry I/O errors.  This is the
        load-bearing half of the atomic-commit invariant — a partial
        directory must never shadow the real latest checkpoint."""
        try:
            entries = io.getdents(self.device, self.root)
        except FileNotFoundError:
            return []
        steps = []
        for e in entries:
            if not e.startswith("step_"):
                continue
            try:
                step = int(e[len("step_"):])
            except ValueError:
                continue
            marker = f"{self.root}/{e}/{COMMIT_MARKER}"
            fd = None
            try:
                fd = io.open(self.device, marker, "r")
                ok = io.pread(self.device, fd, 2, 0) == b"ok"
            except (FileNotFoundError, OSError):
                ok = False
            finally:
                if fd is not None:
                    try:
                        io.close(self.device, fd)
                    except OSError:
                        pass
            if ok:
                steps.append(step)
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        s = self.committed_steps()
        return s[-1] if s else None

    def read_manifest(self, step: int) -> Dict[str, Any]:
        p = f"{self.step_dir(step)}/{MANIFEST}"
        st = io.fstatat(self.device, p)
        fd = io.open(self.device, p, "r")
        data = io.pread(self.device, fd, st.st_size, 0)
        io.close(self.device, fd)
        return json.loads(data)

    def _manifest_chain(self, step: int) -> List[Dict[str, Any]]:
        """Manifests of ``step``'s delta chain, base-first (a full save is a
        chain of one).  Raises :class:`CheckpointError` on a cycle or an
        over-deep chain; a missing base manifest surfaces as the underlying
        FileNotFoundError (both make ``restore_latest`` fall back)."""
        ms = [self.read_manifest(step)]
        seen = {step}
        while ms[0].get("base") is not None:
            b = ms[0]["base"]
            if b in seen or len(ms) > 64:
                raise CheckpointError(
                    f"delta chain at step {step} is cyclic or too deep")
            seen.add(b)
            ms.insert(0, self.read_manifest(b))
        return ms

    def history(self) -> List[SaveInfo]:
        """The committed save history, rebuilt from manifests — the pure
        input :meth:`repro_torch.checkpoint.policy.CheckpointPolicy.keep_steps`
        consumes.  No in-memory retention state exists to lose in a crash."""
        out: List[SaveInfo] = []
        for step in self.committed_steps():
            try:
                m = self.read_manifest(step)
            except (FileNotFoundError, OSError, ValueError):
                continue
            out.append(SaveInfo(step=step,
                                wall_time=float(m.get("wall_time", step)),
                                kind=m.get("kind", "full"),
                                base=m.get("base")))
        return out

    def _wall_time_floor(self) -> float:
        """Highest ``wall_time`` across committed manifests (0.0 when none),
        cached after the first scan and advanced on every successful commit.
        :meth:`save` clamps the stamped wall time to this floor, so the
        history handed to the retention policy is non-decreasing in step
        order even across process restarts and backwards clock steps."""
        if self._wall_floor is None:
            self._wall_floor = max(
                (info.wall_time for info in self.history()), default=0.0)
        return self._wall_floor

    def _delta_base(self, names: List[str], arrays: List[_HostLeaf],
                    ) -> Optional[Tuple[int, Dict[Tuple[str, int, int], int]]]:
        """(base step, effective per-extent CRC map) for a delta save, or
        None when no committed chain can serve as base: nothing committed,
        the leaf spec changed, the chain is at ``max_delta_chain``, or the
        base predates per-extent CRCs."""
        base_step = self.latest_step()
        if base_step is None:
            return None
        try:
            ms = self._manifest_chain(base_step)
        except (CheckpointError, FileNotFoundError, OSError, ValueError):
            return None
        if len(ms) >= self.max_delta_chain:
            return None
        top = ms[-1]
        spec = [(lf["name"], lf["dtype"], tuple(lf["shape"]))
                for lf in top["leaves"]]
        ours = [(names[i], arrays[i].dtype, tuple(arrays[i].shape))
                for i in range(len(names))]
        if spec != ours:
            return None
        crcs: Dict[Tuple[str, int, int], int] = {}
        for m in ms:  # base-first: newer chain members overlay older CRCs
            lnames = [lf["name"] for lf in m["leaves"]]
            for e in m["extents"]:
                if len(e) < 6:
                    return None  # pre-delta manifest: no per-extent CRCs
                li, loff, _s, _soff, ln, crc = e[:6]
                crcs[(lnames[li], loff, ln)] = crc
        return base_step, crcs

    def validate(self, step: int) -> bool:
        """du-shaped parallel fstat over every shard file of every chain
        member; size check.  A delta checkpoint is only as valid as its
        whole chain — a collected or torn base invalidates the delta."""
        try:
            ms = self._manifest_chain(step)
        except (CheckpointError, FileNotFoundError, OSError, ValueError):
            return False

        @self.fa.wrap("stat_list", lambda paths: {"paths": paths})
        def _stat_all(paths):
            return [io.fstatat(self.device, p) for p in paths]

        for m in ms:
            paths = [self._shard_path(m["step"], i)
                     for i in range(m["num_shards"])]
            try:
                stats = _stat_all(paths)
            except FileNotFoundError:
                return False
            if not all(st.st_size == sz
                       for st, sz in zip(stats, m["shard_sizes"])):
                return False
        return True

    # -- restore ---------------------------------------------------------------------
    def _read_step_into(self, m: Dict[str, Any],
                        bufs: Dict[str, bytearray]) -> None:
        """Overlay one chain member's extents into the per-leaf buffers
        (parallel open + chunked pread graphs, as before)."""
        step = m["step"]
        paths = [self._shard_path(step, i) for i in range(m["num_shards"])]

        # read-only opens are pure -> pre-issued as one batch; on a sharded
        # device they fan out to their owning sub-devices in parallel
        @self.fa.wrap("open_list", lambda paths: {"paths": paths})
        def _open_all(paths):
            return [io.open(self.device, p, "r") for p in paths]

        fds = _open_all(paths)
        extents = [_Extent(*e[:5]) for e in m["extents"]]
        # group by owning shard: the round-robin extent plan interleaves
        # shards in manifest order, but within one shard file the extents
        # are densely packed at ascending shard_off.  Sorting by
        # (shard, shard_off) exposes exactly the statically-adjacent
        # same-fd runs the I/O plane's extent coalescer fuses into
        # super-reads, and keeps whole runs on one lane of a multi-queue
        # backend; the overlay below follows the same order, so restored
        # bytes are identical either way.
        extents.sort(key=lambda e: (e.shard, e.shard_off))
        ext_args = [(fds[e.shard], e.length, e.shard_off) for e in extents]

        @self.fa.wrap("pread_extents", lambda extents: {"extents": extents})
        def _read_all(extents):
            return [io.pread(self.device, fd, n, off) for fd, n, off in extents]

        chunks = _read_all(ext_args)
        for fd in fds:
            io.close(self.device, fd)
        lnames = [lf["name"] for lf in m["leaves"]]
        for e, c in zip(extents, chunks):
            if len(c) != e.length:
                raise CheckpointError(
                    f"short read: shard {e.shard} off {e.shard_off}: "
                    f"{len(c)} != {e.length}")
            buf = bufs.get(lnames[e.leaf])
            if buf is None:
                raise CheckpointError(
                    f"chain member {step} has unknown leaf {lnames[e.leaf]}")
            buf[e.leaf_off : e.leaf_off + e.length] = c

    def restore(self, step: int, check_crc: bool = True) -> Tuple[Any, Dict[str, Any]]:
        """Parallel chunked restore -> (flat {name: CPU tensor}, extra).

        A delta checkpoint restores by chaining: the rooting full save is
        read first, then each delta overlays its changed extents base-first.
        The final per-leaf CRC check comes from the *top* manifest, so a
        chained restore is verified byte-identical to what the delta save
        hashed — corruption anywhere in the chain fails the restore (and
        ``restore_latest`` falls back to an older step)."""
        t0 = time.perf_counter()
        ms = self._manifest_chain(step)
        top = ms[-1]
        bufs: Dict[str, bytearray] = {
            leaf["name"]: bytearray(leaf["nbytes"]) for leaf in top["leaves"]}
        for m in ms:
            self._read_step_into(m, bufs)
        t_read = time.perf_counter()
        out: Dict[str, torch.Tensor] = {}
        for leaf in top["leaves"]:
            buf = bufs[leaf["name"]]
            if check_crc and zlib.crc32(buf) != leaf["crc32"]:
                raise CheckpointError(f"crc mismatch for leaf {leaf['name']}")
            out[leaf["name"]] = _from_bytes(buf, leaf["dtype"], leaf["shape"])
        t_end = time.perf_counter()
        self.restore_log.append({"step": step, "seconds": t_end - t0, "read_s": t_read - t0,
                                 "crc_s": t_end - t_read,
                                 "bytes": sum(lf["nbytes"] for lf in top["leaves"])})
        return out, top["extra"]

    def restore_tree(self, step: int, like: Any, check_crc: bool = True) -> Tuple[Any, Dict[str, Any]]:
        """Restore into the structure of ``like`` (names must match): a tree
        of CPU tensors shaped like ``like``.  Where a leaf of ``like`` is a
        tensor, its dtype must match the checkpoint's too."""
        flat, extra = self.restore(step, check_crc=check_crc)
        leaves = []
        for name, proto in zip(leaf_names(like), tree_leaves(like)):
            if name not in flat:
                raise CheckpointError(f"checkpoint missing leaf {name}")
            arr = flat[name]
            proto_shape = tuple(getattr(proto, "shape", ()) or ())
            if proto_shape and tuple(arr.shape) != proto_shape:
                raise CheckpointError(
                    f"shape mismatch for {name}: ckpt {tuple(arr.shape)} vs model {proto_shape}")
            if isinstance(proto, torch.Tensor) and proto.dtype != arr.dtype:
                raise CheckpointError(
                    f"dtype mismatch for {name}: ckpt {arr.dtype} vs model {proto.dtype}")
            leaves.append(arr)
        return tree_unflatten(like, leaves), extra

    def restore_latest(self, like: Any = None) -> Optional[Tuple[int, Any, Dict[str, Any]]]:
        """Newest committed checkpoint that validates; falls back past
        corrupt ones (node-failure recovery path)."""
        for step in reversed(self.committed_steps()):
            try:
                if not self.validate(step):
                    continue
                if like is None:
                    tree, extra = self.restore(step)
                else:
                    tree, extra = self.restore_tree(step, like)
                return step, tree, extra
            except (CheckpointError, FileNotFoundError):
                continue
        return None

    # -- replication ---------------------------------------------------------------
    def replicate(self, step: int, dst: "CheckpointManager") -> None:
        """Copy a committed checkpoint to another tier via Link'ed
        pread->pwrite chains (the cp graph at framework scale).  A delta
        checkpoint replicates its whole chain — a delta without its base is
        unrestorable, so the chain is the unit of replication just as it is
        the unit of retention."""
        for m in self._manifest_chain(step):
            self._replicate_one(m, dst)

    def _replicate_one(self, m: Dict[str, Any], dst: "CheckpointManager") -> None:
        step = m["step"]
        pairs = []
        closers = []
        for i in range(m["num_shards"]):
            sfd = io.open(self.device, self._shard_path(step, i), "r")
            dfd = io.open(dst.device, dst._shard_path(step, i), "w")
            closers.append((sfd, dfd))
            size = m["shard_sizes"][i]
            off = 0
            while off < size or (size == 0 and off == 0):
                n = min(self.chunk_bytes, size - off)
                if n > 0:
                    pairs.append((sfd, dfd, n, off))
                off += max(n, 1)
                if size == 0:
                    break

        # NOTE: source and destination may be different Devices; the copy
        # graph runs on the source's engine, writes go to dst.device through
        # a device-dispatching session only when devices match.  For
        # cross-device replication we fall back to chunked read->write.
        if dst.device is self.device:
            @self.fa.wrap("copy_extents", lambda pairs: {"pairs": pairs})
            def _copy_all(pairs):
                for sfd, dfd, n, off in pairs:
                    data = io.pread(self.device, sfd, n, off)
                    io.pwrite(self.device, dfd, data, off)
            _copy_all(pairs)
        else:
            for sfd, dfd, n, off in pairs:
                data = io.pread(self.device, sfd, n, off)
                io.pwrite(dst.device, dfd, data, off)
        for sfd, dfd in closers:
            io.close(self.device, sfd)
            io.fsync(dst.device, dfd)
            io.close(dst.device, dfd)
        # manifest + commit marker on the destination
        mf = io.open(dst.device, f"{dst.step_dir(step)}/{MANIFEST}", "w")
        io.pwrite(dst.device, mf, json.dumps(m).encode(), 0)
        io.close(dst.device, mf)
        cf = io.open(dst.device, f"{dst.step_dir(step)}/{COMMIT_MARKER}", "w")
        io.pwrite(dst.device, cf, b"ok", 0)
        io.close(dst.device, cf)

    # -- gc ---------------------------------------------------------------------------
    def gc(self) -> None:
        """Policy-driven garbage collection, run after every save.

        The keep-set is :meth:`CheckpointPolicy.keep_steps` over the
        manifest-derived history, always including the newest committed
        step (and, via chain closure, everything it transitively bases on):
        a store that collects the checkpoint it just wrote is useless.
        Victims are collected newest-first so a delta is always gone before
        its base starts being collected — a crash between the two leaves a
        base that is merely unreferenced, never a committed delta with a
        hole under it.  A final sweep finishes any collection a previous
        crash left mid-protocol (tombstone present, marker absent) and
        legacy ``gc``-marker tombstones."""
        committed = self.committed_steps()
        if committed:
            history = self.history()
            by_step = {s.step: s for s in history}
            keep = set(self.policy.keep_steps(history))
            keep.add(committed[-1])
            keep.update(chain_of(committed[-1], by_step))
            for s in sorted((s for s in committed if s not in keep),
                            reverse=True):
                self._collect(s)
        self._sweep()

    def _collect(self, step: int) -> None:
        """Collect one committed step via the GC foreaction graph
        (:func:`build_gc_graph`): tombstone rename, hard commit point,
        then batched unlinks with the tombstone last."""
        d = self.step_dir(step)
        marker = f"{d}/{COMMIT_MARKER}"
        tomb = self._tombstone_path(step)
        try:
            nshards = self.read_manifest(step)["num_shards"]
        except (FileNotFoundError, OSError, ValueError):
            nshards = self.num_shards
        victims = [self._shard_path(step, i) for i in range(nshards)]
        victims.append(f"{d}/{MANIFEST}")
        victims.append(tomb)  # last: its absence means the GC completed

        @self.fa.wrap("ckpt_gc", lambda: {"marker": marker, "tomb": tomb,
                                          "victims": victims})
        def _gc_one():
            io.rename(self.device, marker, tomb)
            sess = current_session()
            if sess is not None and getattr(sess, "staging", None) is not None:
                # point of no return: the tombstone rename survives any
                # abort from here on (see build_gc_graph's protocol notes)
                sess.staging.publish_demanded()
            for p in victims:
                io.unlink(self.device, p)

        _gc_one()
        self._rmdir(d)

    def _sweep(self) -> None:
        """Finish crashed collections.  A step directory is GC-pending iff
        it is *not* committed (no readable ``ok`` marker — an ``ok`` marker
        always wins, covering a crashed non-atomic tombstone copy) but
        still carries a marker tombstone or a legacy ``gc`` marker.
        In killed-save debris (no marker at all) only stale *staging
        extents* are reclaimed: a crashed process cannot roll its staged
        files back, and nothing else ever would.  Deleting a staging extent
        out from under a racing save is safe — its publish rename fails and
        the save aborts cleanly, committing nothing (one save per root at a
        time is the supported regime anyway; the manager serializes its
        own)."""
        try:
            entries = io.getdents(self.device, self.root)
        except FileNotFoundError:
            return
        committed = set(self.committed_steps())
        for e in sorted(entries):
            if not e.startswith("step_"):
                continue
            try:
                step = int(e[len("step_"):])
            except ValueError:
                continue
            if step in committed:
                continue
            d = f"{self.root}/{e}"
            try:
                names = io.getdents(self.device, d)
            except FileNotFoundError:
                names = []
            if (COMMIT_MARKER + GC_TAG) not in names \
                    and COMMIT_MARKER not in names:
                staged = [n for n in names if STAGE_TAG in n]
                for n in sorted(staged):
                    try:
                        self.device.unlink(f"{d}/{n}")
                    except (FileNotFoundError, OSError):
                        pass
                if staged and len(staged) == len(names):
                    self._rmdir(d)  # the crash left nothing but residue
                continue
            victims = [f"{d}/{n}" for n in sorted(names)]

            @self.fa.wrap("unlink_list", lambda: {"victims": victims})
            def _sweep_one():
                for p in victims:
                    io.unlink(self.device, p)

            try:
                _sweep_one()
            except (FileNotFoundError, OSError):
                continue  # racing save/GC elsewhere; retried next pass
            self._rmdir(d)

    def _rmdir(self, d: str) -> None:
        # the emptied step directory itself: a real directory on OSDevice
        # (removed through the unlink verb's rmdir path), implicit on
        # mem-backed devices (gone with its last file)
        try:
            self.device.unlink(d)
        except (FileNotFoundError, OSError):
            pass
