"""On-storage substrate the paper's case studies (§4) run on:

* :mod:`repro_torch.store.recordio`  — fixed-record shard files (data pipeline)
* :mod:`repro_torch.store.staging`   — staged (undoable) creates and renames
  behind the engine's write speculation
* :mod:`repro_torch.store.bptree`    — on-disk B+-tree with Scan / bulk Load (§4.2)
* :mod:`repro_torch.store.lsm`       — LSM-tree key-value store with Get (§4.3)
* :mod:`repro_torch.store.fileutils` — du / cp analogues (§4.1)
* :mod:`repro_torch.store.plugins`   — the foreaction-graph plugin files for all
  of the above (paper Fig. 4), written against :mod:`repro_torch.core`.

All I/O goes through :class:`repro_torch.core.api.io` so that an active
Foreactor session can intercept and speculate; with no session the calls hit
the device directly (original serial behaviour).
"""
