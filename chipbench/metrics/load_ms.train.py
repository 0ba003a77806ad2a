"""Data layer (``data/pipeline.py`` ``TokenBatchLoader.load``): the mean host
time of the program's ``data: load`` span (the whole call, the wait for the
double buffer included) over the window's untraced steps."""

from chipbench.program_spans import mean_host_ms


def read(obs, ctx):
    return mean_host_ms(obs, "data: load")
