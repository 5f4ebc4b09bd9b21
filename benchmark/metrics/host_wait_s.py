"""Mean seconds a training step's host spends waiting to read device
data: the sum of the step's ``train.wait`` spans (the timesteps in the
forward, the clip's norm in the optimizer), over the traced run's steps
that were not profiled."""

from benchmark.harness import spans


def read(cell, res):
    return spans.mean_of(res, "train.step",
                         lambda s: spans.seconds(s, "train.wait"))
