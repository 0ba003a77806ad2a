"""Quickstart (PyTorch port): explicit speculation on a serial stat loop in
~40 lines; twin of ``examples/quickstart.py`` through ``repro_torch``.

    PYTHONPATH=src python examples/quickstart_torch.py
"""

import time

from repro_torch.core import (DeviceProfile, Foreactor, GraphBuilder, MemDevice,
                              SimulatedDevice, Sys, io)

# 1. a slow device with 16-way internal parallelism + some files
inner = MemDevice()
for i in range(60):
    fd = inner.open(f"/photos/img{i:03d}", "w")
    inner.pwrite(fd, b"\xff" * (1000 + i), 0)
    inner.close(fd)
dev = SimulatedDevice(inner, DeviceProfile(channels=16, metadata_latency=2e-3))


# 2. the application function — ordinary serial code
def total_size(paths):
    return sum(io.fstatat(dev, p).st_size for p in paths)


# 3. its foreaction graph (paper Fig. 4a): a loop of independent fstats
def build_graph():
    b = GraphBuilder("stat_loop")
    b.AddSyscallNode("fstat", Sys.FSTATAT,
                     lambda ctx, ep: ((ctx["paths"][ep[0]],), False)
                     if ep[0] < len(ctx["paths"]) else None)
    b.AddBranchingNode("more", lambda ctx, ep: 0 if ep[0] + 1 < len(ctx["paths"]) else 1)
    b.SyscallSetNext("fstat", "more")
    b.BranchAppendChild("more", "fstat", loopback=True)
    b.BranchAppendChild("more", None)
    return b.Build()


paths = [f"/photos/img{i:03d}" for i in range(60)]
fa = Foreactor(device=dev, backend="io_uring", depth=16)
fa.register("stat_loop", build_graph)
speculated = fa.wrap("stat_loop", lambda paths: {"paths": paths})(total_size)

t0 = time.perf_counter(); serial = total_size(paths); t_serial = time.perf_counter() - t0
t0 = time.perf_counter(); fast = speculated(paths); t_fast = time.perf_counter() - t0
assert serial == fast
print(f"serial:     {t_serial*1e3:6.1f} ms")
print(f"speculated: {t_fast*1e3:6.1f} ms   ({t_serial/t_fast:.1f}x, identical result)")
print(f"engine: {fa.total_stats.pre_issued} pre-issued, "
      f"{fa.total_stats.served_async} served async")
fa.shutdown()
