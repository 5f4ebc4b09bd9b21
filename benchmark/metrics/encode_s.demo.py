"""Mean seconds of a demo request's try-on encode: the program's
``serve.encode`` span under its ``demo.request`` (text towers, ViT-H and
the Resampler, the VAE encodes at batch 1), over the traced run's
requests that were not profiled. The service passes no phase dict, so the
span ends when the host has launched the encode, not in a synchronize:
it is the encode's host time, which holds the encode's wall as long as
the host, not the device, is behind."""

from benchmark.harness import spans


def read(cell, res):
    return spans.mean_of(res, "demo.request",
                         lambda s: spans.seconds(s, "serve.encode"))
