"""On-storage substrate of the port's training seam (copies of the
reference package's ``store/`` modules that the data pipeline and the
checkpoint manager need):

* :mod:`repro_torch.store.recordio` — fixed-record shard files (data pipeline)
* :mod:`repro_torch.store.staging`  — staged (undoable) creates and renames
  behind the engine's write speculation

The B+-tree, the LSM tree, the du/cp utilities and their graph plugins are
not ported yet (ROADMAP A9).  All I/O goes through
:class:`repro_torch.core.api.io`, so an active Foreactor session can
intercept and speculate.
"""
