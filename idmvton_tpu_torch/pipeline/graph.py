"""The denoise step as one CUDA graph, replayed once a step.

The port's counterpart of the JAX package's compiled step
(``stepwise_generate``'s jitted ``denoise_step``) and of its one fused
program (``jit_generate``): on a CUDA input the step (GarmentNet, TryonNet,
CFG, the DDPM step and, when on, the inpaint blend) is captured once over
static buffers and replayed for every step of every request with the same
key. Nothing in the step is copied from the host or waits for it:

- the schedule enters as a ``DDPMScheduler.step_table`` copied into a
  static table before a request's first step; the graph gathers row
  ``idx`` from it and adds one to ``idx`` at its end, so one graph serves
  every step of every schedule and the timestep is device data;
- the conditioning, the cached garment features (``garment_cache="once"``)
  and the blend's image latents and noise are copied into static buffers
  before a request's first step, the latent before it too; the graph writes
  the stepped latent back into its buffer;
- each step's noise is drawn before its replay, in the eager loop's order,
  and copied into the noise slot.

A graph bakes in what the step reads on the host while it is captured:
shapes and dtypes, ``impl``, ``garment_cache``, ``guidance_scale`` /
``guidance_rescale``, ``inpaint_blend``, and the switches the kernel sites
read at call time (``ops.dispatch.switches``). Those form its key.
It also holds the addresses of the UNets' weights: ``weights_fingerprint``
(every parameter's name, address, type and shape, and the version that
``quantize_unet_linears_int8`` and the loader bump) drops every graph of a
pipeline when it changes, and the next step captures again.

The kernel wrappers (``ops.dispatch.launch_counters``) count launches in
Python, which a replay does not run.
``CountedCapture`` saves the counters before a capture and restores them
after it, so the capture counts nothing, and adds the capture's increments
at every replay: a replayed step counts what an eager step counts.

The capture is the ``graph.capture`` span (``utils.profiling``), and the
counter ``graph.capture_ns`` sums the captures' nanoseconds.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from idmvton_tpu_torch.models.layers import weights_version
from idmvton_tpu_torch.ops.dispatch import launch_counters, switches
from idmvton_tpu_torch.utils import profiling


class CountedCapture:
    """``with CountedCapture() as cc:`` around a capture: the counters are
    restored on exit and ``cc.delta`` holds what the capture added;
    ``cc.replayed()`` adds it once more, for one replay."""

    def __init__(self, counters: Optional[dict] = None):
        self.counters = counters if counters is not None else \
            launch_counters()
        self.delta = {}

    def __enter__(self):
        self._before = {k: f.launches for k, f in self.counters.items()}
        return self

    def __exit__(self, *exc):
        for k, f in self.counters.items():
            self.delta[k] = f.launches - self._before[k]
            f.launches = self._before[k]
        return False

    def replayed(self):
        for k, n in self.delta.items():
            if n:
                self.counters[k].launches += n


def weights_fingerprint(*modules) -> tuple:
    """What a graph over ``modules`` holds of their weights: each
    parameter's and buffer's name, address, type and shape, and the
    modules' weights versions."""
    out = []
    for m in modules:
        out.append(weights_version(m))
        for name, t in list(m.named_parameters()) + list(m.named_buffers()):
            out.append((name, t.data_ptr(), t.dtype, tuple(t.shape)))
    return tuple(out)


def _shapes(x):
    if x is None:
        return None
    if isinstance(x, dict):
        return tuple((k, _shapes(v)) for k, v in sorted(x.items()))
    if isinstance(x, (tuple, list)):
        return tuple(_shapes(v) for v in x)
    return (tuple(x.shape), x.dtype, x.device)


def graph_key(latents, cond, feats, blend, **options) -> tuple:
    """The key of the graph for a step over these tensors: their shapes,
    types and device, ``options`` (impl, guidance, ...) and ``switches()``."""
    return (_shapes(latents), _shapes(cond), _shapes(feats), _shapes(blend),
            tuple(sorted(options.items())), switches())


class GraphCache:
    """A pipeline's graphs by key, dropped when the weights' fingerprint
    changes."""

    def __init__(self):
        self.graphs = {}
        self.fingerprint = None

    def get(self, fingerprint, key, make: Callable):
        if fingerprint != self.fingerprint:
            self.graphs.clear()
            self.fingerprint = fingerprint
        if key not in self.graphs:
            self.graphs[key] = make()
        return self.graphs[key]


class StepGraph:
    """One denoise step over static buffers: ``start`` loads a request,
    ``step`` runs one step (the first call eagerly, then the capture; every
    later call a replay), ``lat`` holds the current latents.

    ``body(cond, latents, row, noise, feats, blend)`` is the step; it must
    not read the host. ``rows`` is the table's capacity (the most steps a
    schedule may have)."""

    def __init__(self, body: Callable, *, latents, cond, feats, blend,
                 table_cols: int, rows: int):
        dev = latents.device
        self.body = body
        self.lat = torch.empty_like(latents)
        self.noise = torch.empty_like(latents)
        self.cond = {k: torch.empty_like(v) for k, v in cond.items()}
        self.feats = (None if feats is None
                      else tuple(torch.empty_like(f) for f in feats))
        self.blend = (None if blend is None
                      else tuple(torch.empty_like(b) for b in blend))
        self.table = torch.zeros(rows, table_cols, dtype=torch.float32,
                                 device=dev)
        self.idx = torch.zeros(1, dtype=torch.int64, device=dev)
        self.graph = None
        self.counts = None

    def start(self, table, latents, cond, feats=None, blend=None):
        """Copies a request into the static buffers: its step table (a
        (T, table_cols) fp32 tensor on the device), the initial latent, the
        conditioning and the optional features and blend tensors; the next
        step is row 0."""
        if table.shape[0] > self.table.shape[0]:
            raise ValueError(f"{table.shape[0]} steps, the table holds "
                             f"{self.table.shape[0]}")
        self.table[:table.shape[0]].copy_(table)
        self.lat.copy_(latents)
        for k, v in cond.items():
            self.cond[k].copy_(v)
        for dst, src in zip(self.feats or (), feats or ()):
            dst.copy_(src)
        for dst, src in zip(self.blend or (), blend or ()):
            dst.copy_(src)
        self.idx.zero_()

    def _run(self):
        # the TMA tensor maps the C entry points encode at launch are
        # __grid_constant__ kernel parameters, so the capture keeps them by
        # value; the static buffers and the graph's private pool keep their
        # addresses across replays, so the maps stay valid
        row = self.table.index_select(0, self.idx).view(-1)
        new = self.body(self.cond, self.lat, row, self.noise, self.feats,
                        self.blend)
        self.lat.copy_(new)
        self.idx.add_(1)

    def step(self, noise):
        """One step with ``noise`` as its DDPM noise."""
        self.noise.copy_(noise)
        if self.graph is None:
            self.graph, self.counts = self._capture()
        else:
            self.graph.replay()
            self.counts.replayed()

    def _capture(self):
        """Runs the first step eagerly on a side stream (lazy
        initializations and cuBLAS workspaces happen outside the capture),
        then captures the same step; returns (graph, CountedCapture). A
        failure raises: nothing runs eagerly in its place."""
        dev = self.lat.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self._run()
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        with profiling.span("graph.capture") as capture:
            graph = torch.cuda.CUDAGraph()
            with CountedCapture() as counts:
                with torch.cuda.graph(graph, stream=stream):
                    self._run()
            torch.cuda.synchronize(dev)
        profiling.count("graph.capture_ns", capture.end_ns - capture.start_ns)
        return graph, counts
