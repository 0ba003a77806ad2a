"""Staged, undoable write-path speculation (the §3.3 extension).

The paper restricts pre-issuing to syscalls with "no unrecoverable side
effects": a pwrite behind a weak edge may never run early, because if the
function exits before reaching it the bytes are already on disk.  This
module makes those side effects *recoverable*, which is what lets the
engine treat ``Effect.UNDOABLE`` nodes like pure ones (see
``repro_torch.core.syscalls.effect_of`` and docs/ARCHITECTURE.md, "Undoable
write speculation"):

* **Staged creates** — a speculative ``open(path, "w")`` lands in a
  *staging extent*: a temporary name next to the final path (same
  directory, and on a :class:`repro_torch.core.device.ShardedDevice` the same
  sub-device, so publish stays a single atomic rename).  Every write
  through the returned fd hits the staged file; the committed namespace
  never sees partial state.
* **Staged overwrites** — a speculative ``pwrite`` to a pre-existing fd
  first preads the bytes it is about to clobber into the *undo log*, then
  writes in place.  Rollback replays the log in reverse and truncates away
  any extension past the old end.
* **Staged renames** — a speculative ``rename`` to a fresh destination
  executes immediately but logs the old name; rollback renames back.  This
  is what makes the checkpoint GC graph's tombstone rename (de-committing a
  checkpoint by moving its commit marker aside) speculable and abortable.
* **Publish barrier** — a staged create is *published* (renamed onto its
  final path) when the frontier serves the ``close`` of its fd, or — for
  fds the function leaves open — when the session commits.  Until then the
  file is invisible to the committed namespace; after, it is committed even
  if the session later aborts (the close was the commit point, exactly like
  the checkpoint manager's commit marker).
* **Rollback** — ``finalize(ok=False)`` (session raised) or an
  early-exited speculation (the frontier never demanded the node) unwinds:
  staged files are unlinked, overwrite undo entries are replayed newest
  first.  Aborted speculation leaves no trace in the committed namespace
  (``tests/test_conformance.py`` proves it against every backend).

A transaction belongs to one ``SpecSession``; records are appended on the
session thread (at peek or at a frontier serve) but ``applied`` flips on
worker threads, so the record list is lock-protected.

Known limits, documented rather than hidden: overwrite rollback needs the
fd still open at teardown (the Device API addresses writes by fd); a
sparse overwrite that starts past the old end of file leaves the device's
zero padding between old-EOF and the write offset behind after rollback;
and writes *into* a staged file pre-issue only on guaranteed paths —
behind a weak edge they would commit wholesale if the create publishes,
and byte-range undo of un-demanded writes is unsound under concurrent
extends, so the engine keeps them at the frontier
(``SpecSession._make_request``).
"""

from __future__ import annotations

import itertools
import os
import threading
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.device import Device, ShardedDevice
from repro_torch.core.syscalls import resolve_args


class StagingError(RuntimeError):
    """A staging transaction could not fully revert or publish its state."""

#: infix marking a staged (not yet published) file; never appears in a
#: committed namespace because publish renames it away and rollback unlinks
STAGE_TAG = ".__stg"

_txn_counter = itertools.count()


def staged_name(device: Device, path: str, token: str, seq: int) -> str:
    """The staging-extent name for ``path``: same directory, and on a
    sharded device pinned to the same sub-device as the final path, so the
    publish rename never crosses shards (cross-shard rename is a
    non-atomic copy fallback)."""
    if isinstance(device, ShardedDevice):
        shard, sub = device.resolve(path)
        return f"shard{shard}:{sub}{STAGE_TAG}.{token}.{seq}"
    return f"{path}{STAGE_TAG}.{token}.{seq}"


@dataclass
class StageRecord:
    """One undo-log entry: a staged create, a logged overwrite, or an
    undoable rename."""

    kind: str  # "create" | "overwrite" | "rename"
    final_path: Optional[str] = None  # create/rename: where the file ends up
    staged_path: Optional[str] = None  # create: staged name; rename: old name
    flags: Optional[str] = None
    fd: Optional[int] = None  # create: staged fd; overwrite: target fd
    offset: int = 0  # overwrite: where the write landed
    old_data: Optional[bytes] = None  # overwrite: clobbered bytes
    new_len: int = 0  # overwrite: length written
    applied: bool = False  # the runner actually executed
    demanded: bool = False  # the frontier reached (or served) the node
    published: bool = False  # committed: rename done / undo entry dropped
    undone: bool = False


class StagingTxn:
    """The per-session write transaction: staging extents + undo log.

    The engine calls :meth:`stage_create` / :meth:`stage_overwrite` when
    pre-issuing (or frontier-serving) an undoable syscall, marks records
    *demanded* as the frontier reaches them, publishes at close barriers
    via :meth:`on_close`, and settles everything in :meth:`finalize`.
    """

    def __init__(self, device: Device, token: Optional[str] = None):
        self.device = device
        self.token = token if token is not None else (
            f"{os.getpid():x}-{next(_txn_counter):x}")
        self._lock = threading.Lock()
        self._records: List[StageRecord] = []
        self._staged_fds: Dict[int, StageRecord] = {}
        self._seq = itertools.count()
        # observability (tests, bench_write)
        self.published_count = 0
        self.undone_count = 0
        self.rollback_errors: List[BaseException] = []

    # -- staging -----------------------------------------------------------
    def stage_create(self, path: str, flags: str = "w",
                     ) -> Tuple[Callable[[Device], int], StageRecord]:
        """Redirect a truncating-create to a staging extent.  Returns the
        execution runner (for the IORequest) and the undo-log record."""
        rec = StageRecord(kind="create", final_path=path, flags=flags,
                          staged_path=staged_name(self.device, path,
                                                  self.token, next(self._seq)))
        with self._lock:
            self._records.append(rec)

        def runner(device: Device) -> int:
            fd = device.open(rec.staged_path, rec.flags)
            with self._lock:
                rec.fd = fd
                rec.applied = True
                self._staged_fds[fd] = rec
            return fd

        return runner, rec

    def stage_overwrite(self, args: Tuple[Any, ...],
                        ) -> Tuple[Callable[[Device], int], StageRecord]:
        """Wrap a pwrite to a non-staged fd with undo-bytes capture.  The
        fd/data arguments may still be deferred (``FromRequest``); they are
        resolved inside the runner, on the executing worker."""
        rec = StageRecord(kind="overwrite")
        with self._lock:
            self._records.append(rec)

        def runner(device: Device) -> int:
            fd, data, off = resolve_args(args)
            old = device.pread(fd, len(data), off)
            with self._lock:
                rec.fd = fd
                rec.offset = off
                rec.old_data = old
                rec.new_len = len(data)
                rec.applied = True
            return device.pwrite(fd, data, off)

        return runner, rec

    def stage_rename(self, args: Tuple[Any, ...],
                     ) -> Tuple[Callable[[Device], Any], StageRecord]:
        """Wrap a rename so an aborted speculation can rename back.

        The rename executes immediately (like an overwrite, the effect is
        visible as soon as the runner lands); the record remembers the old
        name so rollback restores the namespace.  Sound only for a *fresh*
        destination — an overwriting rename would clobber bytes the
        rename-back cannot restore, the same file-granularity limit staged
        creates have.  The checkpoint GC graph's tombstone rename (a commit
        marker moved to a unique tombstone name) is the canonical user.
        """
        rec = StageRecord(kind="rename")
        with self._lock:
            self._records.append(rec)

        def runner(device: Device):
            src, dst = resolve_args(args)
            out = device.rename(src, dst)
            with self._lock:
                rec.staged_path = src
                rec.final_path = dst
                rec.applied = True
            return out

        return runner, rec

    def is_staged_fd(self, fd: Any) -> bool:
        """True iff ``fd`` refers to a file this transaction created — a
        write through it needs no undo entry (rollback unlinks the file)."""
        with self._lock:
            return fd in self._staged_fds

    # -- commit points -------------------------------------------------------
    def on_demand(self, rec: StageRecord) -> None:
        """The frontier harvested (or served) the record's node: real
        execution now depends on this side effect."""
        rec.demanded = True

    def record_for_fd(self, fd: Any) -> Optional[StageRecord]:
        """The staged-create record ``fd`` currently refers to.  Callers
        must resolve while the fd is provably still open (at pre-issue or
        just before a frontier-served close) — once a close has executed,
        the OS may recycle the number for a later staged create and a raw
        fd lookup would name the wrong record."""
        with self._lock:
            return self._staged_fds.get(fd)

    def publish_demanded(self) -> None:
        """Hard commit point mid-session: publish every record the frontier
        has demanded *now*, in program order, instead of waiting for the
        session to settle.  After this call those effects survive a later
        abort — which is exactly what a forward-only protocol needs at its
        point of no return.  The checkpoint GC graph calls it right after
        the frontier serves the tombstone rename and before any unlink: a
        crash or abort beyond that point must leave the tombstone in place
        (the half-unlinked directory is only safe because it is
        de-committed), while an abort before it rolls the rename back and
        the checkpoint stays fully live."""
        with self._lock:
            records = list(self._records)
        for rec in records:
            if rec.demanded:
                self._publish(rec)

    def publish_close(self, rec: Optional[StageRecord]) -> None:
        """Publish barrier: the frontier served the ``close`` of this
        record's file — rename it onto its final path.  Identity-checked:
        the fd mapping is dropped only if it still points at ``rec`` (a
        recycled fd number belonging to a newer staged create stays)."""
        if rec is None:
            return
        with self._lock:
            if self._staged_fds.get(rec.fd) is rec:
                del self._staged_fds[rec.fd]
        if rec.demanded:
            self._publish(rec)

    def on_close(self, fd: int) -> None:
        """fd-addressed convenience form of :meth:`publish_close`; only
        safe while ``fd`` is still open (no reuse possible)."""
        self.publish_close(self.record_for_fd(fd))

    def _publish(self, rec: StageRecord) -> None:
        if rec.published or rec.undone:
            return
        if rec.kind == "create":
            self.device.rename(rec.staged_path, rec.final_path)
        # overwrite publish = drop the undo entry; bytes are already in place
        rec.published = True
        self.published_count += 1

    def _undo(self, rec: StageRecord) -> None:
        if rec.published or rec.undone or not rec.applied:
            rec.undone = True
            return
        if rec.kind == "create":
            with self._lock:
                # identity check: the fd number may have been reused by a
                # later staged create after the application closed this one
                still_open = self._staged_fds.get(rec.fd) is rec
                if still_open:
                    del self._staged_fds[rec.fd]
            if still_open:
                try:
                    self.device.close(rec.fd)
                except Exception:
                    pass
            try:
                self.device.unlink(rec.staged_path)
            except FileNotFoundError:
                pass
        elif rec.kind == "rename":
            # rename back: the destination was fresh, so this restores the
            # namespace exactly
            self.device.rename(rec.final_path, rec.staged_path)
        else:
            self.device.pwrite(rec.fd, rec.old_data, rec.offset)
            if len(rec.old_data) < rec.new_len:
                # the write extended the file: cut the extension back off
                self.device.truncate(rec.fd, rec.offset + len(rec.old_data))
        rec.undone = True
        self.undone_count += 1

    def finalize(self, ok: bool) -> None:
        """Settle the transaction at session teardown (after the backend
        drained, so no staged runner is still executing).

        ``ok=True`` (the wrapped function returned): publish every record
        the frontier demanded, in program order — commit-marker-last
        protocols keep their ordering — and roll back speculation that ran
        past the real exit.  ``ok=False`` (it raised): roll back everything
        unpublished, newest first, so overlapping undo bytes replay in
        reverse application order.

        A failing undo never abandons the rest of the rollback: every
        record is attempted, failures are collected on
        ``self.rollback_errors``, and they surface as a raised
        :class:`StagingError` on the commit path but only as a warning on
        the abort path — the application's original exception is already
        propagating there and must not be replaced by the cleanup's.
        """
        with self._lock:
            records = list(self._records)
        if ok:
            for rec in records:
                if rec.demanded:
                    self._publish(rec)
        for rec in reversed(records):
            if not rec.published:
                try:
                    self._undo(rec)
                except Exception as e:
                    self.rollback_errors.append(e)
        if self.rollback_errors:
            msg = (f"staging rollback left {len(self.rollback_errors)} "
                   f"record(s) unreverted: {self.rollback_errors[:3]!r}")
            if ok:
                raise StagingError(msg) from self.rollback_errors[0]
            warnings.warn(msg, RuntimeWarning)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "records": len(self._records),
                "published": self.published_count,
                "undone": self.undone_count,
            }
