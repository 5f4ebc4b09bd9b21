"""Mean seconds of a training step's backward (the program's
``train.backward`` span around ``torch.autograd.grad``), over the traced
run's steps that were not profiled."""

from benchmark.harness import spans


def read(cell, res):
    return spans.mean_of(res, "train.step",
                         lambda s: spans.seconds(s, "train.backward"))
