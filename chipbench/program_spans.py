"""The program's own spans and counters (``repro_torch.spans``) for the
per-layer readers.  The module is taken from the ones the run has loaded,
never imported here: a program without it gives the readers nothing to
read, and they return None.

A train step is the program's ``train: step`` span whose host interval holds
the step's boundary in ``obs["boundaries"]`` (step, host time on the clock
``time.perf_counter`` reads, which the spans' ``perf_counter_ns`` stamps
share, traced).  The readers take the window's steps that no profiler
traced, so that their numbers carry none of its host cost.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

STEP = "train: step"


def module():
    return sys.modules.get("repro_torch.spans")


def window_steps(obs, traced: bool = False) -> List[Tuple[object, Dict[str, object], float]]:
    """(the step's span, its child spans by name, its boundary in ns) for
    each window step that a profiler traced, or (by default) did not."""
    spans = module()
    marks = obs.get("boundaries") or []
    if spans is None or len(marks) < 2:
        return []
    recs = spans.records()
    roots = sorted((r for r in recs if r.name == STEP), key=lambda r: r.t0)
    kids: Dict[int, Dict[str, object]] = {}
    for r in recs:
        if r.parent is not None and r.parent.name == STEP:
            kids.setdefault(r.parent.id, {})[r.name] = r
    out = []
    for a, _ in zip(marks, marks[1:]):
        if a[2] != traced:
            continue
        t = a[1] * 1e9
        root = next((r for r in roots if r.t0 <= t <= r.t1), None)
        if root is not None:
            out.append((root, kids.get(root.id, {}), t))
    return out


def mean_host_ms(obs, name: str) -> Optional[float]:
    """The mean host ms of the child span ``name`` over the untraced steps."""
    ms = [k[name].host_ms for _, k, _ in window_steps(obs) if name in k]
    return sum(ms) / len(ms) if ms else None
