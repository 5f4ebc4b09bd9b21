"""Mean seconds of a training step's forward (the program's
``train.forward`` span: the frozen VAE and towers, GarmentNet, TryonNet
and the loss) less the host's wait inside it (its ``train.wait``, the
read of the timesteps), over the traced run's steps that were not
profiled."""

from benchmark.harness import spans


def read(cell, res):
    return spans.mean_of(res, "train.step", lambda s: (
        spans.seconds(s, "train.forward")
        - spans.seconds(s, "train.wait", inside="train.forward")))
