"""Mean seconds of a training step's optimizer (the program's
``train.optimizer`` span: the gradients' global norm, the clip and the
8-bit AdamW update) less the host's wait inside it (its ``train.wait``,
the clip's read of the norm), over the traced run's steps that were not
profiled."""

from benchmark.harness import spans


def read(cell, res):
    return spans.mean_of(res, "train.step", lambda s: (
        spans.seconds(s, "train.optimizer")
        - spans.seconds(s, "train.wait", inside="train.optimizer")))
