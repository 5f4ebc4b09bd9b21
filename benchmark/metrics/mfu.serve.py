"""Model operations of one request (``count.flops.request_ops``) over the
mean wall time of the traced run's requests that were not profiled, as a
percent of the card's bf16 peak."""

from benchmark.count import flops, peaks


def read(cell, res):
    times = [r["seconds"] for r in res["done"] if not r["traced"]]
    if not times:
        return None
    ops = flops.request_ops(cell["config"]["stack"], cell["traffic"])
    return 100.0 * ops / (sum(times) / len(times)) / peaks.BF16_OPS
