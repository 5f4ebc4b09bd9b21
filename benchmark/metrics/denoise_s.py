"""Mean seconds of a request's denoise phase (the pipeline's
``phase_seconds["denoise"]``, which ends in a device synchronize), over
the traced run's requests that were not profiled."""


def read(cell, res):
    d = [r["phases"]["denoise"] for r in res["done"]
         if not r["traced"] and "denoise" in r["phases"]]
    return sum(d) / len(d) if d else None
