"""Model, MoE (``models/mlp.py``; cuBLAS batched products), from the
traced window that records input shapes: the bytes the traced decode
steps' expert products need (the routed experts the step's tokens can
select, at most min(E, B * top_k) a layer; the shared experts;
the dense layers' MLPs; each read once), over those products' device time,
as a share of the datasheet HBM rate."""

from chipbench.frozen import HBM_BYTES_PER_S, decode_step_bytes, ffn_mm_seconds, moe_parts


def read(obs, ctx):
    t = obs.get("traced_host")
    if t is None or ctx.sizes.moe is None:
        return None
    need = decode_step_bytes(ctx.sizes, obs["batch"], obs["cache_len"])
    nbytes = (need["routed"] + need["shared"] + need["dense"]) * obs["host_steps"]
    parts = moe_parts(t.averages_by_shape, ctx.sizes.moe["num_experts"], 0.0, t.cpu_type)
    seconds = parts["moe expert products"] + ffn_mm_seconds(t.averages_by_shape, ctx.sizes,
                                                            t.cpu_type)
    return 100.0 * nbytes / seconds / HBM_BYTES_PER_S if seconds > 0 else None
