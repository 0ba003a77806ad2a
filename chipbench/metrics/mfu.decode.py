"""The whole decode step: its roofline bound (the larger of the frozen
decode model FLOPs over the bf16 peak and the bytes a step needs over the
HBM rate: weights as ``expert_bw_share.decode`` counts them, the rest of
the weights, the head's bf16 table and the cache read) over the median
gap between tokens of the run.  In decode the bytes set the bound."""

import statistics

from chipbench.frozen import HBM_BYTES_PER_S, PEAK_BF16_FLOPS, decode_step_bytes, model_flops


def read(obs, ctx):
    gaps = obs.get("itl_s") or []
    if not gaps:
        return None
    B, L = obs["batch"], obs["cache_len"]
    bound = max(model_flops(ctx.sizes, B, int(L), "decode") / PEAK_BF16_FLOPS,
                sum(decode_step_bytes(ctx.sizes, B, L).values()) / HBM_BYTES_PER_S)
    return 100.0 * bound / statistics.median(gaps)
