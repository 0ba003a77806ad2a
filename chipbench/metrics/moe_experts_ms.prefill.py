"""MoE dropless dispatch (``models/mlp.py`` ``_dropless_dispatch``): the
median over the run's prefill batches of the summed device ms of the
batch's ``moe: experts`` spans (each expert's gated MLP over its run of
sorted rows; CUDA events)."""

from chipbench.serve_spans import median_batch_device_ms


def read(obs, ctx):
    return median_batch_device_ms("moe: experts")
