"""AdamW, host dispatch (``optim/adamw.py`` ``adamw_update``): the mean host
time of the program's ``train: optimizer`` span over the window's untraced
steps."""

from chipbench.program_spans import mean_host_ms


def read(obs, ctx):
    return mean_host_ms(obs, "train: optimizer")
