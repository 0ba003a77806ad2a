"""Step end (``runtime/trainer.py``): the mean host time of the program's
``train: sync`` span, the host blocked until the step's device work has
ended, over the window's untraced steps.  Near 0, the host sets the pace."""

from chipbench.program_spans import mean_host_ms


def read(obs, ctx):
    return mean_host_ms(obs, "train: sync")
