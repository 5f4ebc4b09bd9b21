"""Mean seconds of a demo request's preprocessing on the host: the
program's spans of each net's host part, from the host's read of the
net's outputs on (``openpose.decode``, ``parsing.post``, ``mask.build``,
``densepose.paint``), over the traced run's requests that were not
profiled."""

from benchmark.harness import demo, spans


def read(cell, res):
    return spans.mean_of(res, "demo.request", lambda s: sum(
        spans.seconds(s, name) for name in demo.HOST_SPANS))
