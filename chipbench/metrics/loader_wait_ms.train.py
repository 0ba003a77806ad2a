"""Data layer (``data/pipeline.py`` ``TokenBatchLoader.load``): the mean
host time a step waited in ``load``, timed by the benchmark's wrapper
around each call inside ``Trainer.fit``, over the window's steps."""


def read(obs, ctx):
    waits = obs.get("loader_wait_s") or []
    return 1e3 * sum(waits) / len(waits) if waits else None
