"""Profiling and tracing helpers (counterpart of
``idmvton_tpu/utils/profiling.py``).

- ``trace(logdir)``: a ``torch.profiler`` trace (CPU, and CUDA activity on
  a machine with a card) written to ``logdir`` as a Chrome trace;
- ``annotate(name)``: a named range in that trace
  (``torch.profiler.record_function``);
- ``PhaseTimer``: wall-clock seconds per phase, the device synchronised
  before the clock is read (JAX's ``block_until_ready``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profiles the block; writes ``logdir/trace_{pid}_{ns}.json`` and
    yields the profiler (its ``key_averages()`` after the block)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


def _synchronize(tree):
    """Waits for the devices of every CUDA tensor in ``tree``."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _synchronize(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _synchronize(v)


class PhaseTimer:
    """``with timer.phase("denoise", sync=out): ...`` -- ``sync`` (a tensor
    or a tree of them) is waited for before the clock is read, so the
    recorded wall time covers the device's work."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, *, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name}: {t:.3f}s total, {n}x, {t / n:.4f}s avg")
        return "\n".join(lines)
