"""Deterministic sharded token pipeline (see package docstring).

On a :class:`repro_torch.core.device.ShardedDevice` the record shards are placed on
distinct sub-devices (``Device.place``), so a batch's speculated preads —
whose record permutation is known at activation time — fan out across
per-device queue pairs via the multi-queue backend instead of serializing on
one device (docs/ARCHITECTURE.md, "Sharded multi-device substrate").
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.api import Foreactor, io
from repro_torch.core.device import Device
from repro_torch.core.patterns import register_patterns
from repro_torch.spans import span
from repro_torch.store.recordio import HEADER, RecordShardReader, RecordShardWriter


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    batch_size: int  # per-process batch (global batch / data-parallel hosts)
    seed: int = 0
    dtype: str = "<i4"  # token storage dtype
    #: streaming order: epochs iterate records in storage order (identity
    #: permutation) instead of shuffling.  Consecutive records of a shard
    #: are byte-adjacent in its file, so a batch's pread extents form the
    #: same-fd adjacent runs the I/O plane's extent coalescer fuses into
    #: MB-scale super-reads — the bandwidth-oriented ingestion mode
    #: (evaluation sweeps, dataset conversion, cache warmup).
    sequential: bool = False

    @property
    def record_tokens(self) -> int:
        # +1 token so inputs/labels are a shift of the same record
        return self.seq_len + 1

    @property
    def record_bytes(self) -> int:
        return self.record_tokens * np.dtype(self.dtype).itemsize


def write_synthetic_dataset(
    device: Device, root: str, cfg: DataConfig, num_shards: int,
    records_per_shard: int, vocab_size: int, seed: int = 1234,
) -> List[str]:
    """Generate token shards (synthetic LM data for tests/examples)."""
    rng = np.random.default_rng(seed)
    paths = []
    for s in range(num_shards):
        # shard s lives on sub-device s % N of a ShardedDevice (identity on
        # flat devices) so independent record reads hit independent devices
        path = device.place(f"{root.rstrip('/')}/shard_{s:05d}.rio", hint=s)
        w = RecordShardWriter(device, path, cfg.record_bytes)
        toks = rng.integers(0, vocab_size, size=(records_per_shard, cfg.record_tokens),
                            dtype=np.int32)
        for r in range(records_per_shard):
            w.append(toks[r].astype(cfg.dtype).tobytes())
        w.close()
        paths.append(path)
    return paths


class ShardedTokenDataset:
    """A set of record shards with a global deterministic record order."""

    def __init__(self, device: Device, paths: List[str]):
        self.device = device
        self.readers = [RecordShardReader(device, p) for p in paths]
        counts = [len(r) for r in self.readers]
        self.cum = np.concatenate([[0], np.cumsum(counts)])
        self.total = int(self.cum[-1])
        rb = {r.record_size for r in self.readers}
        if len(rb) != 1:
            raise ValueError("all shards must share a record size")
        self.record_bytes = rb.pop()

    def locate(self, global_idx: int) -> Tuple[int, int]:
        s = int(np.searchsorted(self.cum, global_idx, side="right")) - 1
        return s, int(global_idx - self.cum[s])

    def extent(self, global_idx: int) -> Tuple[int, int, int]:
        """(fd, size, offset) of a record — the pread arguments."""
        s, li = self.locate(global_idx)
        r = self.readers[s]
        return r.fd, self.record_bytes, r.offset_of(li)

    def close(self) -> None:
        for r in self.readers:
            r.close()


class TokenBatchLoader:
    """Deterministic, resumable batch loader with explicit-speculation
    record prefetch.

    Batch ``(epoch, step)`` reads records
    ``perm(seed, epoch)[step*B : (step+1)*B]`` — so ComputeArgs of every
    future pread is known at activation time and the engine keeps
    ``depth`` reads in flight across the whole batch (and, with the
    background double-buffer thread, across batch boundaries too).
    """

    def __init__(self, dataset: ShardedTokenDataset, cfg: DataConfig,
                 fa: Optional[Foreactor] = None, prefetch: bool = True):
        self.ds = dataset
        self.cfg = cfg
        self.fa = fa if fa is not None else Foreactor(device=dataset.device, depth=32)
        # precompile: the first batch load is on the training critical path
        register_patterns(self.fa, precompile=True)
        self.prefetch = prefetch
        self.steps_per_epoch = self.ds.total // cfg.batch_size
        self._perm_cache: Dict[int, np.ndarray] = {}
        # persistent double-buffer worker: one long-lived thread keeps one
        # live backend (queue pairs are per-thread), instead of paying
        # worker-pool construction on every batch
        self._bg: Optional[threading.Thread] = None
        self._bg_req: "queue.Queue[Optional[Tuple[int, int]]]" = queue.Queue()
        self._bg_done = threading.Event()
        self._bg_pending = False
        self._bg_out: Optional[Tuple[Tuple[int, int], np.ndarray]] = None

    def perm(self, epoch: int) -> np.ndarray:
        p = self._perm_cache.get(epoch)
        if p is None:
            if self.cfg.sequential:
                p = np.arange(self.ds.total)
            else:
                rng = np.random.default_rng((self.cfg.seed, epoch))
                p = rng.permutation(self.ds.total)
            self._perm_cache = {epoch: p}  # keep only the active epoch
        return p

    def batch_indices(self, epoch: int, step: int) -> np.ndarray:
        if not (0 <= step < self.steps_per_epoch):
            raise IndexError(f"step {step} out of range")
        B = self.cfg.batch_size
        return self.perm(epoch)[step * B : (step + 1) * B]

    def _read_batch(self, epoch: int, step: int) -> np.ndarray:
        idx = self.batch_indices(epoch, step)
        extents = [self.ds.extent(int(i)) for i in idx]

        if self.prefetch:
            @self.fa.wrap("pread_extents", lambda extents: {"extents": extents})
            def _read(extents):
                return [io.pread(self.ds.device, fd, n, off) for fd, n, off in extents]
            raw = _read(extents)
        else:
            raw = [io.pread(self.ds.device, fd, n, off) for fd, n, off in extents]
        toks = np.stack([np.frombuffer(r, dtype=self.cfg.dtype) for r in raw])
        return toks.astype(np.int32)

    def load(self, epoch: int, step: int) -> Dict[str, np.ndarray]:
        """Return {'tokens': [B,S], 'labels': [B,S]} for (epoch, step).

        If the background double-buffer already holds this batch, it is
        returned immediately and the next batch starts loading.  The call,
        its wait for the double buffer included, is the span ``data: load``.
        """
        with span("data: load", epoch=epoch, step=step):
            rec = None
            if self._bg_pending:
                self._bg_done.wait()
                self._bg_pending = False
                if self._bg_out is not None and self._bg_out[0] == (epoch, step):
                    rec = self._bg_out[1]
                self._bg_out = None
            if rec is None:
                rec = self._read_batch(epoch, step)
            if self.prefetch:
                ns, ne = step + 1, epoch
                if ns >= self.steps_per_epoch:
                    ns, ne = 0, epoch + 1
                self._ensure_worker()
                self._bg_done.clear()
                self._bg_pending = True
                self._bg_req.put((ne, ns))
        return {"tokens": rec[:, :-1], "labels": rec[:, 1:]}

    def _ensure_worker(self) -> None:
        if self._bg is not None:
            return

        def loop():
            while True:
                item = self._bg_req.get()
                if item is None:
                    return
                ep, st = item
                try:
                    self._bg_out = ((ep, st), self._read_batch(ep, st))
                except BaseException:
                    self._bg_out = None
                finally:
                    self._bg_done.set()

        self._bg = threading.Thread(target=loop, name="token-prefetch", daemon=True)
        self._bg.start()

    def close(self) -> None:
        if self._bg_pending:
            self._bg_done.wait()
            self._bg_pending = False
            self._bg_out = None
        if self._bg is not None:
            self._bg_req.put(None)
            self._bg.join(timeout=5)
            self._bg = None
