"""The conv kernels #5 and #6 (``ops/cuda_conv.py``) in the demo's nets:
the bound time of the nets' conv sites that the port sends to them
(``count.preprocess.conv_kernel_site``: 3x3, stride 1, padded 1,
undilated, at least 128 channels in and out; fp32 activations, bf16
weights, the bf16 peak), over the device time of the conv kernel inside
the traced request's ``openpose.net``, ``parsing.net`` and
``densepose.net`` spans, in percent. Every net span ends in the host's
read of the net's outputs, so the kernels that run inside one are the
ones it launched."""

from benchmark.count import peaks, preprocess
from benchmark.harness import demo

KERNELS = ("idm_conv::conv3x3_kernel",)


def read(cell, res):
    tr = res["trace"]
    nets = demo.traced_spans(res, demo.NET_SPANS)
    if tr is None or not nets:
        return None
    dev = sum(b - a for n, a, b, _ in tr.kernels
              if any(k in n for k in KERNELS)
              and any(s.start_ns <= a and b <= s.end_ns for s in nets)) / 1e9
    if dev <= 0:
        return None
    t = cell["traffic"]
    bound = preprocess.conv_kernel_bound_s(
        cell["config"]["nets"], (t["height"], t["width"]), peaks.BF16_OPS,
        peaks.HBM_BPS)
    return 100.0 * bound / dev
