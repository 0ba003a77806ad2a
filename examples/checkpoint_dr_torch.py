"""Disaster-recovery drill through the PyTorch port: checkpoint a model,
corrupt the primary copy, replicate to a second tier with Link'ed
read->write chains, restore; twin of ``examples/checkpoint_dr.py``.

    PYTHONPATH=src python examples/checkpoint_dr_torch.py
"""

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import DeviceProfile, Foreactor, MemDevice, SimulatedDevice

inner = MemDevice()
dev = SimulatedDevice(inner, DeviceProfile(channels=16, base_latency=5e-4))
fa = Foreactor(device=dev, backend="io_uring", depth=32)

primary = CheckpointManager(dev, "/primary", fa=fa, num_shards=8,
                            chunk_bytes=1 << 16)
replica = CheckpointManager(dev, "/replica", fa=fa, num_shards=8,
                            chunk_bytes=1 << 16)

state = {"w": np.random.default_rng(0).normal(size=(512, 512)).astype(np.float32),
         "step": np.asarray(123, np.int32)}
primary.save(123, state, extra={"note": "nightly"})
primary.replicate(123, replica)
print("saved + replicated step 123")

# corrupt the primary
fd = inner.open("/primary/step_0000000123/shard_0000.bin", "w")
inner.pwrite(fd, b"bitrot", 0)
inner.close(fd)
assert primary.restore_latest(like=state) is None  # primary unusable
out = replica.restore_latest(like=state)
assert out is not None and out[0] == 123
np.testing.assert_array_equal(out[1]["w"], state["w"])
print("primary corrupted -> replica restore OK (crc-verified)")
fa.shutdown()
