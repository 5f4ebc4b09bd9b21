"""Mean seconds of a request's decode phase: the program's
``serve.decode`` span (the VAE decode; it ends in a device synchronize
under the harness's ``phase_seconds``), over the traced run's requests
that were not profiled."""

from benchmark.harness import spans


def read(cell, res):
    return spans.mean_of(res, "serve.request",
                         lambda s: spans.seconds(s, "serve.decode"))
