"""MoE capacity dispatch (``models/mlp.py`` ``_moe_capacity``): of the routed
assignments of the traced steps, the share dropped for want of capacity,
from the program's counters ``moe: dropped`` and ``moe: assignments`` (which
count only while a profiler records, once a step)."""

from chipbench.program_spans import module


def read(obs, ctx):
    spans = module()
    if spans is None:
        return None
    c = spans.counters()
    n = c.get("moe: assignments", 0)
    return 100.0 * c.get("moe: dropped", 0) / n if n else None
