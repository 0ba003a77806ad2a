"""Serve loop (``launch/steps.py`` ``make_generate_loop``): device
operations a decode step, over the traced decode steps."""


def read(obs, ctx):
    t = obs.get("traced")
    return t.device_ops / obs["traced_steps"] if t is not None else None
