"""Spans and counters: how the port times itself.

``span(name, **attrs)`` is a context manager.  Each span records its name,
its host start and end (``time.perf_counter_ns``, CLOCK_MONOTONIC, the clock
``time.perf_counter`` reads), its parent (the span open around it), its
root's id (the shared identifier: the spans of one train step or one serve
call share it) and its attributes.  Finished spans go to a bounded ring in
memory; nothing is written out until a reader asks (:func:`records`).

* **The profiler's clock.**  While a ``torch.profiler`` session records, a
  span also enters ``torch.profiler.record_function(name)``, so that it lies
  in the trace on the profiler's own clock and an idle gap inside it is
  named by it.  A range notes the session it entered under and is left
  only while that session still records, or while none does.  Left while a
  later session records, the profiler would write its end into the stopped
  session's freed events and crash the process, so such a range is kept
  until no session records and left then, when its end reaches nothing
  (the stopped session closed it at its stop, or dropped it, as torch's
  version does).  With no profiler running, one flag check is all.
* **The device's clock.**  ``span(name, device=d)`` on a CUDA device also
  records a CUDA event at each end; its device milliseconds are read when a
  reader asks, once the events have completed (``Span.device_ms`` is None
  until then).  Nothing here synchronises or reads from the device.  On
  another device its work runs on the host, so the host clock stands for
  the device's.
* **Counters.**  ``count(name, value)`` adds a host int or a 0-d device
  tensor; device counts add up on the device and are read by
  :func:`counters`.
* **Threads.**  A span's parent is the span current in its ``contextvars``
  context.  Where that is none, or a span already closed (autograd runs a
  CUDA backward on its own thread; ``models.common.remat`` recomputes
  under a copy of the forward's context), the parent is the innermost open
  span opened with ``home=True`` (the train step's backward), on any thread.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextvars import ContextVar
from typing import Any, Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

#: finished spans the ring keeps (a granite train step closes ~60)
RING = 1 << 15


class Span:
    """One span; its fields are read once it has closed."""

    __slots__ = ("name", "id", "parent", "root", "attrs", "t0", "t1", "device", "home",
                 "_ev", "_rf", "_session", "_token", "_rec")

    def __init__(self, rec: "Recorder", name: str, device, home: bool, attrs: Dict[str, Any]):
        self._rec = rec
        self.name = name
        self.attrs = attrs
        self.device = device
        self.home = home
        self.t1: Optional[int] = None

    def __enter__(self) -> "Span":
        rec = self._rec
        parent = _current.get()
        if parent is None or parent.t1 is not None:
            with rec._lock:
                parent = rec._homes[-1] if rec._homes else None
        self.parent = parent
        self.id = next(rec._ids)
        self.root = self.id if parent is None else parent.root
        self._token = _current.set(self)
        if self.home:
            with rec._lock:
                rec._homes.append(self)
        self._rf = None
        if _profiler._is_profiler_enabled:
            if _SESSIONS is not None:
                self._session = _SESSIONS.sessions
                self._rf = torch.profiler.record_function(self.name)
                self._rf.__enter__()
        elif _stale:
            _leave_stale()
        self._ev = None
        if self.device is not None and self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self._ev = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            self._ev[0].record(stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter_ns()
        if self._ev is not None:
            self._ev[1].record(torch.cuda.current_stream(self.device))
        if self._rf is not None:
            _leave(self._rf, self._session)
            self._rf = None
        rec = self._rec
        with rec._lock:
            if self.home:
                rec._homes.remove(self)
            rec._ring.append(self)
        _current.reset(self._token)

    @property
    def parent_id(self) -> Optional[int]:
        return None if self.parent is None else self.parent.id

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def device_ms(self) -> Optional[float]:
        """The device time between the span's ends; None for a span without
        a device, or while its events have not completed."""
        return device_ms_between(self, self)

    def __repr__(self) -> str:
        return f"Span({self.name!r}, id={self.id}, root={self.root}, parent={self.parent_id})"


def device_ms_between(first: Span, last: Span) -> Optional[float]:
    """Device milliseconds from ``first``'s start to ``last``'s end (two
    device spans on one device and stream); None where either has no device
    or ``last``'s end has not completed on the device."""
    if first.device is None or last.device is None or last.t1 is None:
        return None
    if first._ev is None or last._ev is None:
        if first.device.type == "cuda" or last.device.type == "cuda":
            return None
        return (last.t1 - first.t0) / 1e6
    if not last._ev[1].query():
        return None
    return first._ev[0].elapsed_time(last._ev[1])


class Recorder:
    """The ring of finished spans, the open home spans and the counters."""

    def __init__(self, size: int = RING):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=size)
        self._ids = itertools.count(1)
        self._homes: List[Span] = []
        self._counters: Dict[str, Any] = {}

    def span(self, name: str, device=None, home: bool = False, **attrs) -> Span:
        return Span(self, name, device, home, attrs)

    def count(self, name: str, value) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def records(self) -> List[Span]:
        with self._lock:
            return list(self._ring)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            items = list(self._counters.items())
        return {k: int(v) for k, v in items}


_current: ContextVar[Optional[Span]] = ContextVar("repro_torch_span", default=None)
_recorder = Recorder()


def _count_sessions():
    """torch's hook that starts each profiler session, wrapped once to count
    them in its attribute ``sessions``; None where torch has no such hook,
    and then no span enters a range.  The first session's start also enters
    and leaves one range before the profiler records: a process's first
    range costs milliseconds of torch's lazy set-up, which the profiler's
    start-up then carries, not the first span inside the session."""
    start = getattr(_profiler, "_run_on_profiler_start", None)
    if start is None or hasattr(start, "sessions"):
        return start

    def started():
        if not started.sessions:
            with torch.profiler.record_function("repro_torch.spans: set-up"):
                pass
        started.sessions += 1
        start()

    started.sessions = 0
    _profiler._run_on_profiler_start = started
    return started


_SESSIONS = _count_sessions()
_stale: List[Any] = []  # ranges whose session stopped while a later one records
_stale_lock = threading.Lock()


def _leave(rf, session: int) -> None:
    """Leave the range ``rf`` entered under ``session``, or keep it for
    :func:`_leave_stale` where another session records now."""
    if not _profiler._is_profiler_enabled or session == _SESSIONS.sessions:
        rf.__exit__(None, None, None)
    else:
        with _stale_lock:
            _stale.append(rf)


def _leave_stale() -> None:
    """Leave the kept ranges, while no profiler session records."""
    with _stale_lock:
        kept = _stale[:]
        del _stale[:]
    for rf in kept:
        rf.__exit__(None, None, None)


def span(name: str, device=None, home: bool = False, **attrs) -> Span:
    """A span named ``name`` with attributes ``attrs``; ``device`` (a
    ``torch.device``) also times it on that device's clock; ``home``: spans
    that find no open span current in their context take this one as their
    parent while it is open."""
    return _recorder.span(name, device, home, **attrs)


def count(name: str, value) -> None:
    """Add ``value`` (a host int or a 0-d tensor, added up on its device) to
    the counter ``name``."""
    _recorder.count(name, value)


def profiling() -> bool:
    """True while a ``torch.profiler`` session records."""
    return _profiler._is_profiler_enabled


def records() -> List[Span]:
    """The finished spans the ring holds, oldest first by end."""
    return _recorder.records()


def counters() -> Dict[str, int]:
    """Each counter's total; device counts are read from the device here."""
    return _recorder.counters()


def reset(size: int = RING) -> None:
    """An empty ring of ``size`` spans and no counters."""
    global _recorder
    _recorder = Recorder(size)
