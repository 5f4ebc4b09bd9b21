"""Mean seconds of a request's encode phase: the program's
``serve.encode`` span (text towers, ViT-H and the Resampler, the VAE
encodes; with the harness's ``phase_seconds`` it ends in a device
synchronize), over the traced run's requests that were not profiled."""

from benchmark.harness import spans


def read(cell, res):
    return spans.mean_of(res, "serve.request",
                         lambda s: spans.seconds(s, "serve.encode"))
