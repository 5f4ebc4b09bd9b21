"""Mean seconds of a demo request's preprocessing: the program's four
stage spans ``demo.openpose``, ``demo.parsing``, ``demo.mask`` and
``demo.densepose`` under its ``demo.request``, over the traced run's
requests that were not profiled. The wait for the service's lock counts
in the first of them."""

from benchmark.harness import demo, spans


def read(cell, res):
    return spans.mean_of(res, "demo.request", lambda s: sum(
        spans.seconds(s, name) for name in demo.STAGES))
