"""The traced window of a ``--trace 1`` run: ``torch.profiler`` over a few
steady units of the cell's work, and what the readers need from it.

A window traces the device alone (kernels, copies, memsets and the CUDA
runtime calls, by CUPTI), or with ``host`` the host's operators too, and
with ``shapes`` their input shapes.  Recording every host operator doubles
a decode step's host time, so the device's busy time, its operations and
the idle gaps come from a device-only window, and what needs the host's
ranges or shapes from a second one.  A window starts after a
``synchronize`` and ends after one; a host window is also a profiler
range, whose span it takes.  Where the profiler returns no device event,
the window is traced once more, and then left to CUDA events
(:class:`Fallback`).  From the device events: the busy time (the union of
their intervals), the device operations, the operations that took most
time, the idle gaps named by what the host was doing then (the innermost
host event open across the gap's middle: an operator, or in a device-only
window a CUDA runtime call), and the key averages for the readers.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

WINDOW = "chipbench: traced window"
RETRIES = 1  # a window with no device event is traced this many times more


@dataclass
class Traced:
    window_s: float
    busy_s: float
    device_ops: int
    top_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    #: device kernels in order: (name, start_us, duration_us)
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    #: host ranges' device time, e.g. "plain backward: attention" -> seconds
    ranges_device_s: Dict[str, float] = field(default_factory=dict)
    averages_by_shape: Any = None
    cpu_type: Any = None

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


class Window:
    """The traced window over ``units`` whole units of work.  The driver
    calls :meth:`tick` at each boundary between units from where tracing
    may begin: the first tick starts the profiler, the ``units``-th after it
    stops it (or :meth:`stop` does, where the work ends first).

    ``traced`` holds the analysis once stopped.  A window in which the
    profiler saw no device event is traced once more from the next
    boundary (``retries`` counts it); where the second sees none either,
    ``traced`` stays None and ``fallback`` holds the traced units' span on
    the device's clock (CUDA events), the only reading left."""

    def __init__(self, torch, device, units: int, host: bool = False, shapes: bool = False):
        self.torch = torch
        self.device = device
        self.units = units
        self.host = host or shapes or device.type != "cuda"
        self.shapes = shapes
        self.retries = 0
        self.prof = None
        self.rf = None
        self.traced: Optional[Traced] = None
        self.fallback: Optional[Fallback] = None
        self.done = False
        self.count = 0

    @property
    def running(self) -> bool:
        return self.prof is not None

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] if self.host else []
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            self.torch.cuda.synchronize()
        return profile(activities=acts, record_shapes=self.shapes)

    def warm(self) -> None:
        """One short profile in set-up, so that the profiler's own start-up
        (loading and arming the device tracer) is not paid in the window."""
        x = self.torch.ones(256, 256, device=self.device)
        with self._profile():
            (x @ x).sum().item()

    def tick(self) -> None:
        if self.done:
            return
        if self.prof is None:
            self.start()
            return
        self.count += 1
        if self.count >= self.units:
            self.stop()

    def start(self) -> None:
        from chipbench.harness import Stamp
        self.prof = self._profile()
        self.prof.start()
        if self.host:
            self.rf = self.torch.profiler.record_function(WINDOW)
            self.rf.__enter__()
        self.t0, self.stamp0 = time.perf_counter(), Stamp(self.torch, self.device)
        self.count = 0

    def stop(self, last: bool = False) -> None:
        """Close the window; ``last``: the work ends here, so no retry (and
        a retry still waiting for its start is given up)."""
        from chipbench.harness import Stamp
        if self.prof is None:
            self.done = self.done or last
            return
        stamp1 = Stamp(self.torch, self.device)
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
        window_s = time.perf_counter() - self.t0
        if self.host:
            self.rf.__exit__(None, None, None)
        self.prof.stop()
        traced = analyse(self.prof, window_s, self.shapes)
        self.prof = None
        if traced is None and self.retries < RETRIES and not last:
            self.retries += 1  # traced again from the next boundary
            return
        self.traced, self.done, self.units = traced, True, self.count
        if traced is None:
            self.fallback = Fallback(window_s=window_s, span_s=stamp1.ms_since(self.stamp0) / 1e3)


@dataclass
class Fallback:
    """A window the profiler saw no device event in: its length on the
    host's clock and the traced units' span on the device's (an upper
    bound of the busy time)."""

    window_s: float
    span_s: float


def window_obs(win: Optional[Window]) -> Dict[str, Any]:
    """A traced run's window readings for the readers and the result line."""
    if win is None:
        return {"traced": None}
    return {"traced": win.traced, "fallback": win.fallback, "profiler_retries": win.retries}


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def analyse(prof, window_s: float, shapes: bool) -> Optional[Traced]:
    """The window's readings; ``window_s``, its length on the host's clock,
    stands for a device-only window's (which has no profiler range)."""
    import numpy as np
    from torch.autograd import DeviceType

    events = list(prof.events())
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    # device events only: kernels, copies, memsets; the device-side spans of
    # host ranges (which share their host event's name) would count twice
    host_names = {e.name for e in cpu}
    dev = [e for e in events if e.device_type != DeviceType.CPU and e.name not in host_names]
    win = [e for e in cpu if e.name == WINDOW]
    if win:
        w0, w1 = win[0].time_range.start, win[0].time_range.end
        window_s = (w1 - w0) / 1e6
        dev = [e for e in dev if w0 <= e.time_range.start <= w1]
    kernels = sorted(((e.name, e.time_range.start, e.time_range.end - e.time_range.start)
                      for e in dev), key=lambda k: k[1])
    if not kernels:
        return None
    if not win:
        w0, w1 = kernels[0][1], max(s + d for _, s, d in kernels)
    busy = _merge([(s, s + d) for _, s, d in kernels])
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = defaultdict(float)
    for name, _, d in kernels:
        by_name[name] += d / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # idle gaps, each named by the innermost host event open across its middle
    edges = [(w0, w0)] + busy + [(w1, w1)]
    gaps = [(edges[i][1], edges[i + 1][0]) for i in range(len(edges) - 1)
            if edges[i + 1][0] > edges[i][1]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:400]
    host = [e for e in cpu if e.name != WINDOW]
    starts = np.array([e.time_range.start for e in host], dtype=np.float64)
    ends = np.array([e.time_range.end for e in host], dtype=np.float64)
    named: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        open_ = np.nonzero((starts <= mid) & (ends >= mid))[0] if len(host) else []
        name = host[int(open_[np.argmax(starts[open_])])].name if len(open_) else "(no host event)"
        named[name] += (b - a) / 1e6
    idle = sorted(named.items(), key=lambda kv: -kv[1])[:10]
    ranges = defaultdict(float)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU and (e.key.startswith("plain backward")
                                                or e.key.startswith("chipbench:")):
            ranges[e.key] += e.device_time_total / 1e6
    return Traced(window_s=window_s, busy_s=busy_us / 1e6, device_ops=len(kernels),
                  top_ops=top, idle_gaps=idle, kernels=kernels, ranges_device_s=dict(ranges),
                  averages_by_shape=(prof.key_averages(group_by_input_shape=True)
                                     if shapes else None),
                  cpu_type=DeviceType.CPU)
