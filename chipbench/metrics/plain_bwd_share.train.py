"""Kernel front door (``kernels/ops.py``): the device time of the kernels
launched inside the ``plain backward: *`` ranges, as a share of the device
busy time of the traced window that records the host's ranges."""


def read(obs, ctx):
    t = obs.get("traced_host")
    if t is None:
        return None
    plain = sum(s for k, s in t.ranges_device_s.items() if k.startswith("plain backward"))
    return 100.0 * plain / t.busy_s if plain > 0 else None
