"""Training input pipeline with explicit-speculation prefetch.

Tokenized sequences live in fixed-record shards (:mod:`repro_torch.store.recordio`).
Batch composition is a pure function of (seed, epoch, step), so the exact
``pread`` extents of any future batch are computable ahead of time — the
textbook case for a foreaction graph (regular I/O loop, paper §4.1), and
the reason *explicit* speculation needs no prediction machinery here.

The loader is deterministic and resumable from (epoch, step) alone, which
is what makes checkpoint/restart and elastic rescaling exact.
"""

from .pipeline import DataConfig, ShardedTokenDataset, TokenBatchLoader, write_synthetic_dataset

__all__ = ["DataConfig", "ShardedTokenDataset", "TokenBatchLoader", "write_synthetic_dataset"]
