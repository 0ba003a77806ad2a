"""The whole train step (``launch/steps.py`` ``make_train_step``): the
frozen model FLOPs of the window's steps over their time (step boundary to
step boundary, the profiled steps of a traced run left out), as a share of
the bf16 datasheet peak."""

from chipbench.frozen import PEAK_BF16_FLOPS, model_flops


def read(obs, ctx):
    marks = obs.get("boundaries") or []
    spans = [b[1] - a[1] for a, b in zip(marks, marks[1:]) if not a[2]]
    if not spans:
        return None
    flops = model_flops(ctx.sizes, obs["batch"], obs["seq"], "train") * len(spans)
    return 100.0 * flops / sum(spans) / PEAK_BF16_FLOPS
