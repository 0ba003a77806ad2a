"""Syscall trace recording — the *observe* half of observe-then-speculate.

The paper's adoption cost is hand-writing foreaction graphs.  This module
removes it for a large class of functions: run the function once (or a few
times) under a :class:`TraceRecorder`, and the recorded syscall trace —
ordered events with full argument and result values — becomes the input to
the graph miner (:mod:`repro_torch.analysis.mine`), which folds traces into a
directly-follows graph and emits a ready-to-register ``ForeactionGraph``.

A ``TraceRecorder`` rides the same per-thread activation stack that
``SpecSession`` uses: while it is on top, every ``io.*`` call on that thread
executes *directly* against the device (no speculation, no extra crossings
beyond the serial baseline) and is appended to the trace.  Recording cost is
one tuple append per call — near-zero next to any real device latency.

Cross-references: docs/AUTHORING.md ("Mining a graph from traces") is the
end-to-end guide; *trace* and *directly-follows graph* are defined in
docs/GLOSSARY.md.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional, Tuple

from .device import Device
from .syscalls import Sys, execute


@dataclass
class TraceEvent:
    """One recorded syscall: position, descriptor, arguments, and outcome.

    ``result`` holds the live return value (bytes for pread, fd int for
    open, stat object, entry list) — the miner needs the real values for
    argument-provenance detection, so no summarization happens here.
    """

    seq: int
    sc: Sys
    args: Tuple[Any, ...]
    result: Any = None
    error: Optional[BaseException] = None
    t_seconds: float = 0.0  # service time of this call (serial, by design)

    def kind(self) -> Sys:
        return self.sc


class Trace:
    """An ordered sequence of :class:`TraceEvent` from one invocation."""

    def __init__(self, name: str = "trace"):
        self.name = name
        self.events: List[TraceEvent] = []
        self.wall_seconds: float = 0.0

    def append(self, ev: TraceEvent) -> None:
        self.events.append(ev)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[TraceEvent]:
        return iter(self.events)

    def __getitem__(self, i: int) -> TraceEvent:
        return self.events[i]

    def kinds(self) -> List[Sys]:
        """The syscall-kind string of the trace — the miner's alphabet."""
        return [ev.sc for ev in self.events]

    def to_jsonable(self, max_bytes: int = 32) -> List[Dict[str, Any]]:
        """A JSON-friendly rendering for docs/debugging (large byte values
        are abbreviated; objects fall back to repr)."""

        def _render(v: Any) -> Any:
            if isinstance(v, bytes):
                if len(v) > max_bytes:
                    return f"<{len(v)} bytes>"
                return v.hex()
            if isinstance(v, (int, float, str, bool)) or v is None:
                return v
            if isinstance(v, (list, tuple)):
                return [_render(x) for x in v]
            return repr(v)

        return [
            {
                "seq": ev.seq,
                "sc": ev.sc.value,
                "args": _render(ev.args),
                "result": _render(ev.result),
                "error": repr(ev.error) if ev.error is not None else None,
            }
            for ev in self.events
        ]


class TraceRing:
    """Bounded per-endpoint store of sampled ``(ctx, trace)`` pairs.

    Every trace pins the raw result of each recorded I/O (the miner needs
    the live values for provenance detection), so an unbounded trace list
    under sustained sampling grows by one buffer set per sampled request —
    the original ``Foreactor._traces`` list did exactly that when
    ``observe`` ran long.  The ring keeps the *newest* ``capacity`` pairs
    (the ones that describe the current live pattern, which is what online
    re-mining wants) and counts what it evicted, so ``trace_stats`` can
    report drop pressure instead of hiding it.
    """

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError(f"trace ring capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._items: Deque[Tuple[Dict[str, Any], "Trace"]] = deque(
            maxlen=capacity)
        #: total pairs ever appended (survivors + dropped)
        self.recorded = 0
        #: pairs evicted to make room — nonzero means sampling outpaces
        #: re-mining cadence (docs/TUNING.md, "Sample rate vs re-mine
        #: cadence")
        self.dropped = 0

    def append(self, ctx: Dict[str, Any], trace: "Trace") -> None:
        if len(self._items) == self.capacity:
            self.dropped += 1
        self._items.append((ctx, trace))
        self.recorded += 1

    def snapshot(self) -> List[Tuple[Dict[str, Any], "Trace"]]:
        return list(self._items)

    def clear(self) -> None:
        self._items.clear()

    def __len__(self) -> int:
        return len(self._items)

    def stats(self) -> Dict[str, int]:
        return {
            "capacity": self.capacity,
            "resident": len(self._items),
            "recorded": self.recorded,
            "dropped": self.dropped,
        }


class TraceRecorder:
    """Records every intercepted I/O call while active on a thread.

    Duck-types the slice of the ``SpecSession`` surface the interception
    layer (:class:`repro_torch.core.api.io`) touches: ``.device`` for routing and
    ``.intercept(sc, args)`` for the call itself.  Execution is strictly
    serial and direct — observation must not perturb the behaviour being
    recorded (the mined graph describes the *serial* order, exactly what the
    pre-issuing engine needs).
    """

    def __init__(self, device: Device, name: str = "trace"):
        self.device = device
        self.trace = Trace(name)
        self._t0 = time.perf_counter()

    def intercept(self, sc: Sys, args: Tuple[Any, ...]) -> Any:
        t0 = time.perf_counter()
        ev = TraceEvent(seq=len(self.trace.events), sc=sc, args=args)
        self.trace.append(ev)
        try:
            self.device.charge_crossing()
            result = execute(self.device, sc, args)
        except BaseException as e:
            ev.error = e
            ev.t_seconds = time.perf_counter() - t0
            raise
        ev.result = result
        ev.t_seconds = time.perf_counter() - t0
        return result

    def finish(self) -> Trace:
        self.trace.wall_seconds = time.perf_counter() - self._t0
        return self.trace


class RecordingSession:
    """A *sampled* activation: records the live syscall pattern instead of
    speculating on it — the trace sampler half of online re-mining.

    ``Foreactor.activate`` returns one of these for the 1-in-N activations
    an attached :class:`repro_torch.analysis.remine.ReMiner` elects to sample.
    It duck-types the slice of the ``SpecSession`` surface that
    ``Foreactor.deactivate``, ``Foreactor.wrap`` and the interception layer
    touch (``device``, ``intercept``, ``mark_failed``, ``finish`` returning
    a ``SessionStats``), executes strictly serially like a
    :class:`TraceRecorder` (observation must not perturb the pattern being
    observed), and on clean finish delivers its ``(ctx, trace)`` pair to
    the per-endpoint :class:`TraceRing` via the ``sink`` callback.  A
    failed activation delivers nothing — the miner only learns from clean
    runs.  Unsampled activations never touch this class, so the steady-
    state cost of having a re-miner attached is one counter increment per
    activation.
    """

    #: lets Foreactor.deactivate tell a sampling activation from a real one
    is_recording = True

    def __init__(self, device: Device, name: str, ctx: Dict[str, Any],
                 sink: Optional[Callable[[str, Dict[str, Any], Trace],
                                         None]] = None):
        from .engine import SessionStats  # engine does not import trace

        self.device = device
        self.graph_name = name
        self.graph_version = 0
        self.ctx = dict(ctx)
        self.backend = None  # no speculation: nothing to lease or shut down
        self.stats = SessionStats()
        self._recorder = TraceRecorder(device, name=name)
        self._sink = sink
        self._failed = False
        self._finished = False

    def intercept(self, sc: Sys, args: Tuple[Any, ...]) -> Any:
        self.stats.intercepted += 1
        self.stats.served_sync += 1
        return self._recorder.intercept(sc, args)

    def mark_failed(self) -> None:
        self._failed = True

    def finish(self):
        if not self._finished:
            self._finished = True
            trace = self._recorder.finish()
            if not self._failed and self._sink is not None:
                self._sink(self.graph_name, self.ctx, trace)
        return self.stats
