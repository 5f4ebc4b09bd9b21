"""Spans, counters and traces of the port (counterpart of
``idmvton_tpu/utils/profiling.py``).

- ``span(name, **attrs)``: a timed range of the program. Every span goes
  into a bounded ring of the last ``RING_SPANS`` spans (``spans()``) with
  its parent and its root (the outermost span of its thread: a request or
  a training step). Stamps are nanoseconds on the Unix epoch, the clock
  ``torch.profiler`` stamps host events with, so a span lines up with the
  device trace of the same window. While a profiler runs, and only then,
  a span also opens a range of its name in the profiler's host events
  (``_host_range``).
- ``count(name, n)``: integer counters, never evicted (``counters()``).
- ``timed(name, seconds, key, sync)``: a span that, given a ``seconds``
  dict, ends in a device synchronize and stores its duration there.
- ``trace(logdir=None)``: a ``torch.profiler`` trace (CPU, and CUDA
  activity on a machine with a card) kept in memory; a Chrome trace is
  written only when ``logdir`` is given.
- ``PhaseTimer``: wall-clock seconds per phase, the device synchronised
  before the clock is read (JAX's ``block_until_ready``).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

# A span's range in a running profiler: a host event of the span's name,
# of the scope aten's operators have. ``record_function``'s user scope
# would also put a copy of the range on the device's timeline
# (``gpu_user_annotation``), which a device trace counts as busy time.
_host_range = _RecordFunctionFast

RING_SPANS = 4096

_ring: collections.deque = collections.deque(maxlen=RING_SPANS)
_counts: Dict[str, int] = {}
_count_lock = threading.Lock()
_ids = itertools.count(1)
_recording = True
# Unix-epoch ns minus perf-counter ns, taken again when a root opens; a
# span adds the value it finds at its open to both its stamps, so its
# duration is a difference of perf-counter readings
_offset_ns = time.time_ns() - time.perf_counter_ns()
_clock = time.perf_counter_ns


class _Stack(threading.local):
    def __init__(self):
        self.open = []


_stack = _Stack()


def counters() -> Dict[str, int]:
    """A snapshot of every counter."""
    with _count_lock:
        return dict(_counts)


def count(name: str, n: int = 1) -> None:
    with _count_lock:
        _counts[name] = _counts.get(name, 0) + n


def spans() -> list:
    """The ring's spans, oldest first (in the order they closed)."""
    return list(_ring)


def set_recording(on: bool) -> None:
    """Turns the ring on or off; a span still times itself when it is off
    (``timed`` and ``PhaseTimer`` read it) but is not kept."""
    global _recording
    _recording = bool(on)


class Span:
    """One timed range: ``name``, ``attrs``, ``start_ns`` / ``end_ns``
    (Unix-epoch ns), ``id``, ``parent`` (the enclosing span's id, None for a
    root) and ``root`` (the root's id)."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "start_ns",
                 "end_ns", "_offset", "_range")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self.id = self.parent = self.root = self._range = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self):
        global _offset_ns
        if _recording:
            stack = _stack.open
            self.id = next(_ids)
            if stack:
                top = stack[-1]
                self.parent = top.id
                self.root = top.root
            else:
                self.root = self.id
                t0 = _clock()
                now = time.time_ns()
                t1 = _clock()
                if t1 - t0 < 20_000:    # not preempted between the reads
                    _offset_ns = now - (t0 + t1) // 2
            stack.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self._range = _host_range(self.name)
            self._range.__enter__()
        self._offset = _offset_ns
        self.start_ns = _clock() + self._offset
        return self

    def __exit__(self, *exc):
        self.end_ns = _clock() + self._offset
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if self.id is not None:
            _stack.open.remove(self)
            _ring.append(self)
        return False


span = Span     # ``with span("serve.step", mode="replay"): ...``


def _synchronize(tree):
    """Waits for a CUDA device, or for the devices of every CUDA tensor in
    ``tree``."""
    if isinstance(tree, torch.device):
        if tree.type == "cuda":
            torch.cuda.synchronize(tree)
    elif isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _synchronize(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _synchronize(v)


@contextlib.contextmanager
def timed(name: str, seconds: Optional[dict] = None,
          key: Optional[str] = None, sync=None):
    """``span(name)``. With a ``seconds`` dict, the span ends after waiting
    for ``sync`` (a device or a tree of tensors) and its seconds go into
    ``seconds[key]``; without one nothing waits."""
    s = span(name)
    try:
        with s:
            yield s
            if seconds is not None and sync is not None:
                _synchronize(sync)
    finally:
        if seconds is not None:
            seconds[key] = s.seconds


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profiles the block and yields the profiler, its events in memory
    (``key_averages()``, ``events()`` after the block); with ``logdir``,
    also writes them to ``logdir/trace_{pid}_{ns}.json`` as a Chrome
    trace."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class PhaseTimer:
    """``with timer.phase("denoise", sync=out): ...`` -- ``timed`` under the
    phase's name, its seconds added to the phase's total; ``sync`` (a tensor
    or a tree of them) is waited for before the span closes, so the recorded
    wall time covers the device's work."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, *, sync=None):
        seconds = {}
        try:
            with timed(name, seconds, name, sync):
                yield
        finally:
            self.totals[name] += seconds[name]
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name}: {t:.3f}s total, {n}x, {t / n:.4f}s avg")
        return "\n".join(lines)
