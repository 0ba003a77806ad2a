"""Device, untraced: the mean device time from the start of the program's
``train: forward`` span to the end of its ``train: optimizer`` span (their
CUDA events) over the window's untraced steps.  The step's time less this
is the device's idle time between steps, without the profiler."""

from chipbench.program_spans import module, window_steps


def read(obs, ctx):
    spans = module()
    ms = [spans.device_ms_between(k["train: forward"], k["train: optimizer"])
          for _, k, _ in window_steps(obs) if "train: forward" in k and "train: optimizer" in k]
    ms = [m for m in ms if m is not None]
    return sum(ms) / len(ms) if ms else None
