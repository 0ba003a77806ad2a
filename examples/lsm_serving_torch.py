"""Serve batched Get requests from an LSM record store with explicit
speculation (the paper's LevelDB case as a feature-store server), through
the PyTorch port; twin of ``examples/lsm_serving.py``.

    PYTHONPATH=src python examples/lsm_serving_torch.py
"""

import time

import numpy as np

from repro_torch.core import DeviceProfile, Foreactor, MemDevice, SimulatedDevice
from repro_torch.store import plugins
from repro_torch.store.lsm import LSMTree

# build a store with overlapping L0 tables (long Get chains)
rng = np.random.default_rng(0)
inner = MemDevice()
store = LSMTree(inner, "/features", memtable_limit_bytes=1 << 15,
                l0_limit=10**6, fsync_writes=False)
ref = {}
for k in rng.permutation(3000):
    v = rng.bytes(128)
    store.put(int(k), v)
    ref[int(k)] = v
store.flush()
print(f"store: {store.table_count()} tables, "
      f"levels {[len(l) for l in store.levels]}")

dev = SimulatedDevice(inner, DeviceProfile(channels=16, base_latency=1e-3),
                      cache_bytes=1 << 18)
server = LSMTree.open_existing(dev, "/features")
fa = Foreactor(device=dev, backend="io_uring", depth=16)
plugins.register_all(fa)
get = fa.wrap("lsm_get", plugins.capture_lsm_get)(lambda s, k: s.get(k))

requests = [int(k) for k in rng.choice(3000, 100)]
t0 = time.perf_counter()
for k in requests:
    assert server.get(k) == ref[k]
t_serial = time.perf_counter() - t0
t0 = time.perf_counter()
for k in requests:
    assert get(server, k) == ref[k]
t_spec = time.perf_counter() - t0
print(f"100 Gets serial:    {t_serial*1e3:6.0f} ms ({100/t_serial:.0f} req/s)")
print(f"100 Gets speculated:{t_spec*1e3:6.0f} ms ({100/t_spec:.0f} req/s)  "
      f"-> {t_serial/t_spec:.2f}x")
fa.shutdown()
