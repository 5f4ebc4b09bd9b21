"""Seconds the program spent capturing its denoise step as a CUDA graph
(the counter ``graph.capture_ns``, which the ``graph.capture`` span adds
to): the capture happens in set-up, at the warm-up request's first step,
and counters are never evicted. 0 where nothing was captured (a CPU
run)."""

from benchmark.harness import spans


def read(cell, res):
    ns = spans.counter("graph.capture_ns")
    return None if ns is None else ns / 1e9
