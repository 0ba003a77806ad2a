"""The program's serve spans (``repro_torch.spans``) for the prefill
readers: each ``serve: prefill`` span that opened with no span around it
(``launch/steps.py`` ``make_prefill_step``, one a batch) and the device
time of the spans of one name that it holds.  The module is taken from the
ones the run has loaded (:func:`chipbench.program_spans.module`): a program
without it, or without spans of that name, gives nothing to read.
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional

from chipbench.program_spans import module

PREFILL = "serve: prefill"


def batch_device_ms(name: str) -> Dict[int, float]:
    """Per ``serve: prefill`` batch (by its span's id), the summed device ms
    of the spans named ``name`` inside it; a batch with one such span whose
    device time is not known is left out."""
    spans = module()
    if spans is None:
        return {}
    recs = spans.records()
    batches = {r.id for r in recs if r.name == PREFILL and r.parent is None}
    out: Dict[int, float] = {}
    unknown = set()
    for r in recs:
        if r.name != name or r.root not in batches:
            continue
        ms = r.device_ms
        if ms is None:
            unknown.add(r.root)
        else:
            out[r.root] = out.get(r.root, 0.0) + ms
    return {b: ms for b, ms in out.items() if b not in unknown}


def median_batch_device_ms(name: str) -> Optional[float]:
    """The median over the run's prefill batches of :func:`batch_device_ms`."""
    per = batch_device_ms(name)
    return statistics.median(per.values()) if per else None
