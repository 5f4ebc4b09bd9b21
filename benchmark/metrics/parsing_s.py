"""Mean seconds of a demo request's ``demo.parsing``, the stage's span,
over the traced run's requests that were not profiled."""

from benchmark.harness import spans


def read(cell, res):
    return spans.mean_of(res, "demo.request",
                         lambda s: spans.seconds(s, "demo.parsing"))
