"""Model operations of one demo request, the three nets' at their served
input sizes (``count.preprocess.request_ops``) and the batch-1 try-on's
(``count.flops.request_ops``), over the mean wall time of the traced run's
requests that were not profiled, as a percent of the card's bf16 peak."""

from benchmark.count import flops, peaks, preprocess


def read(cell, res):
    times = [r["seconds"] for r in res["done"] if not r["traced"]]
    if not times:
        return None
    tr = cell["traffic"]
    ops = (preprocess.request_ops(cell["config"]["nets"],
                                  (tr["height"], tr["width"]))
           + flops.request_ops(cell["config"]["stack"], tr))
    return 100.0 * ops / (sum(times) / len(times)) / peaks.BF16_OPS
