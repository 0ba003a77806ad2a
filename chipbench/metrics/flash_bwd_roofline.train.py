"""Kernels (``csrc/flash_attention.cu``): the least time of the traced
steps' attention backwards, over the summed device time of the backward
kernels (``fa_bwd_*``, two a layer a step).  The least time of one layer's
backward is the larger of its FLOP bound (the mathematics' five products,
10 D operations a visible pair, at the bf16 peak) and its byte bound (Q, K,
V, O and dO read, dQ, dK and dV written, the fp32 LSE and delta, at the HBM
rate).  The kernels form S and dP three times, nine products in all, so
the reading cannot pass 5/9 of 100%."""

import re

from chipbench.frozen import HBM_BYTES_PER_S, PEAK_BF16_FLOPS

FA_BWD = re.compile(r"\bfa_bwd_")


def layer_bound_s(B: int, H: int, KV: int, S: int, D: int) -> float:
    """One causal layer's backward at S = T, its pairs counted as
    ``flash_fwd_bound_s`` counts them."""
    pairs = S * (S + 1) / 2
    flops = 10.0 * B * H * pairs * D
    nbytes = 2 * (4 * B * H * S * D + 4 * B * KV * S * D) + 4 * 2 * B * H * S
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def read(obs, ctx):
    t = obs.get("traced")
    if t is None:
        return None
    s = ctx.sizes
    layers = sum(1 for k in s.blocks if k == "attn")
    steps = obs.get("traced_steps") or 0
    calls = [d for name, _, d in t.kernels if FA_BWD.search(name)]
    if not calls or len(calls) != 2 * layers * steps:
        return None
    bound = layers * steps * layer_bound_s(obs["batch"], s.n_heads, s.n_kv_heads, obs["seq"],
                                           s.hd)
    return 100.0 * bound / (sum(calls) / 1e6)
