"""Kernel #1 (``ops/cuda_norm.py::ln_linear``): the bound time of every
LayerNorm + linear site of the traced request's replayed steps (the larger
of its operations over the bf16 peak and its bytes over HBM bandwidth,
``count.flops.ln_linear``) over the device time of the kernels named
here (the statistics pre-pass and the GEMM) in those steps, in percent."""

from benchmark.count import flops, peaks

KERNELS = ("ln_linear_kernel", "ln_stats_kernel")


def read(cell, res):
    tr = res["trace"]
    if tr is None or not tr.graph_launches:
        return None
    dev = tr.kernel_s(KERNELS, graph_only=True)
    if dev <= 0:
        return None
    sites = [s for s in flops.step_sites(cell["config"]["stack"],
                                         cell["traffic"])
             if s["kind"] == "ln_linear"]
    bound = sum(flops.bound_seconds(s["ops"], s["bytes"], peaks.BF16_OPS,
                                    peaks.HBM_BPS) for s in sites)
    return 100.0 * tr.graph_launches * bound / dev
