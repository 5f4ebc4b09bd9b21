"""Mean seconds of a demo request's try-on: the program's ``demo.tryon``
span under its ``demo.request`` (the batch-1 encode, 30 replayed steps and
the decode, ending in the host's read of the result), over the traced
run's requests that were not profiled."""

from benchmark.harness import spans


def read(cell, res):
    return spans.mean_of(res, "demo.request",
                         lambda s: spans.seconds(s, "demo.tryon"))
