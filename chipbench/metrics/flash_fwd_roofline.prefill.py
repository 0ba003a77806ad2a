"""Kernels (``csrc/flash_attention.cu``): the least time of each traced
``fa_fwd_bf16`` call from its shapes (the larger of its FLOP and byte
bounds), summed, over the calls' summed device time."""

from chipbench.frozen import FLASH_FWD_BF16, flash_fwd_bound_s


def read(obs, ctx):
    t = obs.get("traced")
    if t is None:
        return None
    s = ctx.sizes
    calls = [d for name, _, d in t.kernels if FLASH_FWD_BF16.search(name)]
    per_batch = sum(1 for k in s.blocks if k in ("attn", "mla"))
    if not calls or len(calls) != per_batch * len(obs["traced_lens"]):
        return None
    D = s.hd if s.mla is None else s.mla["qk_nope"] + s.mla["qk_rope"]
    bound = sum(per_batch * flash_fwd_bound_s(obs["batch"], s.n_heads, s.n_kv_heads, S, S, D, True)
                for S in obs["traced_lens"])
    return 100.0 * bound / (sum(calls) / 1e6)
