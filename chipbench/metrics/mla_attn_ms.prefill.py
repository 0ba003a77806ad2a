"""MLA attention (``models/attention.py`` ``mla_prefill``): the median over
the run's prefill batches of the summed device ms of the batch's
``attn: mla`` spans (the latent and query projections, YaRN, the per-head
keys and values, the flash kernel at head_dim 192 and ``wo``; CUDA events)."""

from chipbench.serve_spans import median_batch_device_ms


def read(obs, ctx):
    return median_batch_device_ms("attn: mla")
