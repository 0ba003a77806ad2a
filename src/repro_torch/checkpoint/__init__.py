"""Fault-tolerant sharded checkpointing with foreactor-parallel I/O.

* Save: leaves are packed into N shard files (one per I/O writer — the
  per-host analogue), written through a guaranteed-pwrite foreaction graph,
  then committed atomically (manifest + COMMIT marker last).
* Restore: manifest -> parallel fstat validation (du-shaped graph) ->
  parallel chunked preads (Fig. 4a-shaped graph) -> pytree reassembly.
* Replicate: checkpoint copy between storage tiers via Link'ed pread->pwrite
  chains (cp-shaped graph, Fig. 4b).
* Fault tolerance: corrupt/missing shards are detected by size+crc checks
  and restore falls back to the newest older committed step.
* Lifecycle: every save is followed by a policy-driven GC pass
  (:class:`repro_torch.checkpoint.policy.CheckpointPolicy`) that collects
  superseded steps through a crash-safe tombstone-rename + unlink
  foreaction graph; ``save(..., delta=True)`` writes only the extents
  whose CRCs changed since the newest committed chain, and restore chains
  base + deltas back to a byte-identical tree.
"""

from .manager import CheckpointManager, CheckpointError, build_gc_graph
from .policy import CheckpointPolicy, SaveInfo, chain_of

__all__ = ["CheckpointManager", "CheckpointError", "CheckpointPolicy",
           "SaveInfo", "build_gc_graph", "chain_of"]
