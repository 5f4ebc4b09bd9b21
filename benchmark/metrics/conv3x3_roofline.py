"""Kernel #5 (``ops/cuda_conv.py::conv3x3``): the bound time of the two
UNets' 3x3 stride-1 conv sites that the port sends to #5 (input and
output channels at least 128, input channels a multiple of 32, output
channels of 8, width at least 8, one image under 32 MiB; a GarmentNet's
trailing upsample conv included, as the port runs it), over the device
time of the kernels named here in the traced request's replayed steps, in
percent."""

from benchmark.count import flops, peaks

KERNELS = ("idm_conv::conv3x3_kernel",)


def conv3x3_site(s) -> bool:
    if s["kind"] != "conv" or s["k"] != 3 or s["stride"] != 1:
        return False
    b, h, w, cin, cout = s["shape"]
    return (cin >= 128 and cout >= 128 and cin % 32 == 0 and cout % 8 == 0
            and w >= 8 and h * w * cin * 2 < 32 * 2 ** 20)


def read(cell, res):
    tr = res["trace"]
    if tr is None or not tr.graph_launches:
        return None
    dev = tr.kernel_s(KERNELS, graph_only=True)
    if dev <= 0:
        return None
    sites = [s for s in flops.step_sites(cell["config"]["stack"],
                                         cell["traffic"]) if conv3x3_site(s)]
    bound = sum(flops.bound_seconds(s["ops"], s["bytes"], peaks.BF16_OPS,
                                    peaks.HBM_BPS) for s in sites)
    return 100.0 * tr.graph_launches * bound / dev
