"""MoE dropless dispatch (``models/mlp.py`` ``_dropless_dispatch``): the
most-loaded expert's rows over the mean expert's, E x ``moe: expert rows
max`` / ``moe: expert rows``, from the program's counters (the host's
counts of each call's split, added while a profiler records: the traced
batches).  1 is an even load; the largest expert's products set the
grouped products' tail."""

from chipbench.program_spans import module


def read(obs, ctx):
    spans = module()
    if spans is None or ctx.sizes.moe is None:
        return None
    c = spans.counters()
    rows = c.get("moe: expert rows", 0)
    return ctx.sizes.moe["num_experts"] * c.get("moe: expert rows max", 0) / rows if rows else None
