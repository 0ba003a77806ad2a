"""Model forward, host dispatch (``launch/steps.py`` ``make_train_step``):
the mean host time of the program's ``train: forward`` span over the
window's untraced steps."""

from chipbench.program_spans import mean_host_ms


def read(obs, ctx):
    return mean_host_ms(obs, "train: forward")
