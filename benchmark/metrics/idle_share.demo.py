"""Percent of a demo request's wall time in which no operation ran on the
device: 1 - the traced request's device busy time over the mean wall time
of the run's requests that were not profiled (the profiler's own host
work stretches the traced request's wall)."""


def read(cell, res):
    tr = res["trace"]
    times = [r["seconds"] for r in res["done"] if not r["traced"]]
    if tr is None or not tr.kernels or not times:
        return None
    return 100.0 * (1.0 - tr.busy_s() / (sum(times) / len(times)))
