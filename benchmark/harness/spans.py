"""The program's own spans (``idmvton_tpu_torch/utils/profiling.py``) of a
run's window, for the per-layer metrics that read them.

The program keeps its last spans in a ring, each with its parent and its
root (a request's ``serve.request``, a step's ``train.step``). The run's
last ``len(res["done"])`` roots of the cell's kind are the window's
requests or steps, one to one and in order; the profiled one is dropped.
Where the program has no ring (a program older than its spans), or the
ring holds fewer such roots than the window's records, or has evicted a
span of the first of them, the readers get None."""

from __future__ import annotations


def _profiling():
    try:
        from idmvton_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans") or not hasattr(profiling,
                                                      "counters"):
        return None
    return profiling


def window(res: dict, root: str):
    """[(root span, [its other spans])] of the window's records that were
    not profiled, or None."""
    prof = _profiling()
    done = res["done"]
    if prof is None or not done:
        return None
    ring = prof.spans()
    roots = [s for s in ring if s.name == root and s.parent is None]
    if len(roots) < len(done):
        return None
    roots = roots[len(roots) - len(done):]
    full = len(ring) >= getattr(prof, "RING_SPANS", len(ring) + 1)
    if full and ring[0].end_ns > roots[0].start_ns:
        return None
    kept = {r.id: (r, []) for r, rec in zip(roots, done)
            if not rec["traced"]}
    for s in ring:
        if s.root in kept and s.parent is not None:
            kept[s.root][1].append(s)
    return list(kept.values()) or None


def seconds(spans, name: str, inside: str = None) -> float:
    """The summed seconds of ``spans`` named ``name``; with ``inside``,
    only those within a span named ``inside``."""
    outer = [s for s in spans if s.name == inside]
    return sum(s.seconds for s in spans if s.name == name and (
        inside is None or any(o.start_ns <= s.start_ns and
                              s.end_ns <= o.end_ns for o in outer)))


def mean_of(res: dict, root: str, fn):
    """The mean of ``fn(spans)`` over the window's unprofiled records."""
    recs = window(res, root)
    if recs is None:
        return None
    vals = [fn(spans) for _, spans in recs]
    return sum(vals) / len(vals)


def counter(name: str):
    """The program's counter ``name`` (0 where it never counted), or None
    for a program without counters."""
    prof = _profiling()
    return None if prof is None else prof.counters().get(name, 0)
