"""The traced window: one request or one step under ``torch.profiler``,
its events kept in memory (no trace file), reduced to device intervals.

Busy time is the union of the device's kernel, memcpy and memset
intervals; a kernel launched by ``cudaGraphLaunch`` belongs to a replayed
step. Device time is grouped by kernel name with ``GROUPS`` (a copy of the
groups of the repository's step profile)."""

from __future__ import annotations

import time

import torch

# (group, substrings of the kernel name), the first match wins
GROUPS = (("ln_linear_i8 GEGLU", ("ln_linear_i8_kernel<true",
                                   "ln_linear_i8_kernel<128, true",
                                   "ln_linear_i8_kernel<256, true")),
          ("ln_linear_i8", ("ln_linear_i8_kernel",)),
          ("ln_linear_i8 quantization pre-pass", ("ln_quant_kernel",)),
          ("ln_linear GEGLU", ("ln_linear_kernel<true",
                               "ln_linear_kernel<128, true",
                               "ln_linear_kernel<256, true")),
          ("ln_linear", ("ln_linear_kernel",)),
          ("ln_linear statistics pre-pass", ("ln_stats_kernel",)),
          ("flash_attention_gemm", ("flash_gemm_kernel",)),
          ("cross_attention_small_kv", ("cross_small_kernel",)),
          ("conv3x3 / conv3x3_padacc (wgmma)", ("idm_conv::conv3x3_kernel",)),
          ("gn_spatial_stats", ("gn_",)),
          ("fused_layer_norm", ("layer_norm_kernel",)),
          ("cuBLAS GEMMs (aten::mm, bmm)", ("nvjet", "gemm")),
          ("copies (casts, cat, pad)", ("copy", "CatArray", "pad")),
          ("elementwise", ("elementwise",)),
          ("reductions", ("reduce",)))


def group_of(name: str) -> str:
    return next((g for g, keys in GROUPS if any(k in name for k in keys)),
                "other")


def union_ns(intervals) -> int:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class Trace:
    """The reduced events of one profiled call: ``kernels`` [(name, start,
    end, graph)] in ns, the host ops [(name, start, end)], the call's host
    wall seconds and its graph launches."""

    def __init__(self, kernels, host_ops, wall_s, graph_launches):
        self.kernels = kernels
        self.host_ops = host_ops
        self.wall_s = wall_s
        self.graph_launches = graph_launches

    def busy_s(self, graph_only=False) -> float:
        return union_ns([(a, b) for _, a, b, g in self.kernels
                         if g or not graph_only]) / 1e9

    def kernel_s(self, substrings, graph_only=False) -> float:
        return sum(b - a for n, a, b, g in self.kernels
                   if (g or not graph_only)
                   and any(s in n for s in substrings)) / 1e9

    def device_ops(self, top=10):
        out = {}
        for n, a, b, _ in self.kernels:
            g = group_of(n)
            out[g] = out.get(g, 0.0) + (b - a) / 1e9
        return sorted(([k, v] for k, v in out.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top=10):
        """The longest gaps between device intervals, each named by the
        innermost host op running at its start."""
        ivs = sorted((a, b) for _, a, b, _ in self.kernels)
        gaps, end = [], None
        for a, b in ivs:
            if end is not None and a > end:
                gaps.append((a - end, end))
            end = b if end is None else max(end, b)
        gaps.sort(reverse=True)
        out = []
        for length, at in gaps[:top]:
            cover = [(e - s, n) for n, s, e in self.host_ops if s <= at < e]
            name = min(cover)[1] if cover else "host (no op)"
            out.append([name, length / 1e9])
        return out


def _is_device(e) -> bool:
    return "CUDA" in str(e.device_type())


def profiled(fn):
    """Runs ``fn()`` under the profiler; returns (its result, Trace)."""
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    graph_corr = set()
    host_ops = []
    for e in events:
        if _is_device(e):
            continue
        name = e.name()
        if name == "cudaGraphLaunch":
            graph_corr.add(e.correlation_id())
        host_ops.append((name, e.start_ns(), e.end_ns()))
    kernels = []
    for e in events:
        if not _is_device(e) or e.end_ns() <= e.start_ns():
            continue
        corr = {e.correlation_id(), e.linked_correlation_id()} - {0}
        kernels.append((e.name(), e.start_ns(), e.end_ns(),
                        bool(corr & graph_corr)))
    launches = sum(1 for n, _, _ in host_ops if n == "cudaGraphLaunch")
    return out, Trace(kernels, host_ops, wall, launches)
