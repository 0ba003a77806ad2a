"""Speculation (``core/engine.py``): of the reads the engine pre-issued in
the window, the share it served asynchronously (its own counters,
``served_async / pre_issued``, summed over the loader's sessions)."""


def read(obs, ctx):
    pre, served = obs.get("spec") or (0, 0)
    return served / pre if pre else None
