"""The whole prefill step (``launch/steps.py`` ``make_prefill_step``): the
frozen prefill model FLOPs of the run's batches over their times to first
token, as a share of the bf16 datasheet peak."""

from chipbench.frozen import PEAK_BF16_FLOPS, model_flops


def read(obs, ctx):
    batches = obs.get("ttft_s") or []
    if not batches:
        return None
    flops = sum(model_flops(ctx.sizes, obs["batch"], S, "prefill") for S, _ in batches)
    return 100.0 * flops / sum(dt for _, dt in batches) / PEAK_BF16_FLOPS
