"""Device: the share of the device-only traced window (the host's
operators not recorded, whose recording would slow the host) in which no
device operation ran (the union of the kernels', copies' and memsets'
intervals is the busy time)."""


def read(obs, ctx):
    t = obs.get("traced")
    return 100.0 * t.idle_share if t is not None else None
