"""Model operations of one train step (``count.flops.train_step_ops``:
the frozen forwards, and three times the trained forwards; remat's
recompute not counted) over the mean wall time of the traced run's steps
that were not profiled, as a percent of the card's bf16 peak."""

from benchmark.count import flops, peaks


def read(cell, res):
    times = [r["seconds"] for r in res["done"] if not r["traced"]]
    if not times:
        return None
    ops = flops.train_step_ops(cell["config"]["stack"], cell["traffic"])
    return 100.0 * ops / (sum(times) / len(times)) / peaks.BF16_OPS
