"""Frozen operation and byte counts of the demo's three preprocessing nets
(configuration ``idmvton_demo_preprocess``), as functions of its ``nets``
section and the traffic's photo size.

Operations are 2 x multiply-accumulates of the convolutions, transposed
convolutions and FC products the published nets need at the served input
sizes, over every slot the served path computes (DensePose's box head over
all ``rpn_post_nms_topk`` proposal slots, its DensePose head over all
``num_detections`` detection slots: the program's shapes are static). A
conv site's bytes are its fp32 input read once, its weights read once as
the conv kernels take them (bf16), its fp32 output written once and its
fp32 bias. Sites carry ``kind``, ``k``, ``stride``, ``dilation`` and
``shape`` (b, h, w, cin, cout), the input's.
"""

from __future__ import annotations

from benchmark.count.flops import FP32, BF16


def _conv(out, net, b, h, w, cin, cout, k=3, stride=1, dilation=1,
          pad=None, name=None):
    """Appends a conv site; returns its output (h, w)."""
    pad = dilation * (k // 2) if pad is None else pad
    ho = (h + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    wo = (w + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    ops = 2 * b * ho * wo * k * k * cin * cout
    nbytes = (FP32 * b * h * w * cin + BF16 * k * k * cin * cout
              + FP32 * b * ho * wo * cout + FP32 * cout)
    out.append(dict(kind="conv", net=net, name=name, k=k, stride=stride,
                    dilation=dilation, pad=pad, shape=(b, h, w, cin, cout),
                    ops=ops, bytes=nbytes))
    return ho, wo


def _fc(out, net, m, k, n):
    out.append(dict(kind="linear", net=net, ops=2 * m * k * n,
                    bytes=FP32 * (m * k + k * n + m * n + n)))


def _pool(n, k, s, p):
    return (n + 2 * p - k) // s + 1


# ---------------------------------------------------------------------------
# served input sizes
# ---------------------------------------------------------------------------


def openpose_input(cfg):
    """(H, W) of OpenPose's input: the demo's 384x512 person resized by
    scale * boxsize / 512 (OpenCV rounds), padded to the stride."""
    h, w = cfg["image"]
    s = cfg["scales"][0] * cfg["boxsize"] / h
    ih, iw = int(round(h * s)), int(round(w * s))
    st = cfg["stride"]
    return ih + (-ih) % st, iw + (-iw) % st


def densepose_input(cfg, photo_hw):
    """(H, W) of the R-CNN's input: ResizeShortestEdge, padded to the
    size divisibility."""
    h, w = photo_hw
    scale = cfg["short_edge"] / min(h, w)
    if max(h, w) * scale > cfg["max_size"]:
        scale = cfg["max_size"] / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    d = cfg["size_divisibility"]
    return nh + (-nh) % d, nw + (-nw) % d


# ---------------------------------------------------------------------------
# walks
# ---------------------------------------------------------------------------


def openpose_sites(cfg, h, w):
    from benchmark.reference.preprocess import (
        OPENPOSE_POOL_AFTER, openpose_blocks,
    )
    out = []
    blocks = openpose_blocks(cfg)
    hw = (h, w)
    for name, i, o, k in blocks["model0"]:
        hw = _conv(out, "openpose", 1, *hw, i, o, k)
        if name in OPENPOSE_POOL_AFTER:
            hw = (hw[0] // 2, hw[1] // 2)
    for block, convs in blocks.items():
        if block == "model0":
            continue
        for _, i, o, k in convs:
            _conv(out, "openpose", 1, *hw, i, o, k)
    return out


def schp_sites(cfg, classes, size):
    out = []
    net = "schp"
    hw = _conv(out, net, 1, size, size, 3, 64, stride=2)
    hw = _conv(out, net, 1, *hw, 64, 64)
    hw = _conv(out, net, 1, *hw, 64, 128)
    hw = (_pool(hw[0], 3, 2, 1), _pool(hw[1], 3, 2, 1))
    inplanes, feats = 128, []
    for i, (n, stride, dil) in enumerate(zip(cfg["blocks"], cfg["strides"],
                                             cfg["dilations"])):
        planes = 64 * 2 ** i
        for bi in range(n):
            s = stride if bi == 0 else 1
            cin = inplanes if bi == 0 else 4 * planes
            _conv(out, net, 1, *hw, cin, planes, 1)
            hw2 = _conv(out, net, 1, *hw, planes, planes, 3, stride=s,
                        dilation=dil)
            _conv(out, net, 1, *hw2, planes, 4 * planes, 1)
            if bi == 0 and (s != 1 or inplanes != 4 * planes):
                _conv(out, net, 1, *hw, cin, 4 * planes, 1, stride=s)
            hw = hw2
        inplanes = 4 * planes
        feats.append(hw)
    x2, x3, x4, x5 = feats
    for size_ in cfg["psp_sizes"]:
        _conv(out, net, 1, size_, size_, 2048, 512, 1)
    _conv(out, net, 1, *x5, 2048 + 512 * len(cfg["psp_sizes"]), 512)
    _conv(out, net, 1, *x5, 512, 256, 1)          # decoder
    _conv(out, net, 1, *x2, 256, 48, 1)
    _conv(out, net, 1, *x2, 304, 256, 1)
    _conv(out, net, 1, *x2, 256, 256, 1)
    _conv(out, net, 1, *x2, 256, classes, 1, name="parsing_logits")
    for hw_, cin in ((x2, 256), (x3, 512), (x4, 1024)):   # edge
        _conv(out, net, 1, *hw_, cin, 256, 1)
        _conv(out, net, 1, *hw_, 256, 2, 3, name="edge_logits")
    _conv(out, net, 1, *x2, 6, 2, 1, name="edge_logits")
    _conv(out, net, 1, *x2, 1024, 256, 1)         # fusion
    _conv(out, net, 1, *x2, 256, classes, 1)
    return out


def densepose_sites(cfg, h, w):
    out = []
    net = "densepose"
    hw = _conv(out, net, 1, h, w, 3, 64, 7, stride=2)
    hw = (_pool(hw[0], 3, 2, 1), _pool(hw[1], 3, 2, 1))
    inplanes, levels = 64, []
    for li, n in enumerate((3, 4, 6, 3)):
        planes = 64 * 2 ** li
        for bi in range(n):
            s = 2 if li and bi == 0 else 1
            cin = inplanes if bi == 0 else 4 * planes
            hw2 = _conv(out, net, 1, *hw, cin, planes, 1, stride=s)
            _conv(out, net, 1, *hw2, planes, planes, 3)
            _conv(out, net, 1, *hw2, planes, 4 * planes, 1)
            if bi == 0:
                _conv(out, net, 1, *hw, cin, 4 * planes, 1, stride=s)
            hw = hw2
        inplanes = 4 * planes
        levels.append((hw, inplanes))
    dim = 256
    ps = []
    for (hw_, cin) in levels:
        _conv(out, net, 1, *hw_, cin, dim, 1)
    for (hw_, _) in levels:
        _conv(out, net, 1, *hw_, dim, dim, 3)
        ps.append(hw_)
    ps.append(((ps[3][0] + 1) // 2, (ps[3][1] + 1) // 2))
    a = len(cfg["aspect_ratios"])
    for hw_ in ps:                                  # RPN
        _conv(out, net, 1, *hw_, dim, dim, 3)
        _conv(out, net, 1, *hw_, dim, a, 1)
        _conv(out, net, 1, *hw_, dim, 4 * a, 1)
    r, pool, fc = cfg["rpn_post_nms_topk"], cfg["box_pooler"], cfg["box_fc"]
    _fc(out, net, r, dim * pool * pool, fc)
    _fc(out, net, r, fc, fc)
    _fc(out, net, r, fc, 2)
    _fc(out, net, r, fc, 4)
    dd = cfg["decoder_dim"]
    for lvl in range(4):                            # decoder
        hw_ = ps[lvl]
        for j in range(max(1, lvl)):
            _conv(out, net, 1, *hw_, dim if j == 0 else dd, dd, 3)
            if lvl:
                hw_ = (2 * hw_[0], 2 * hw_[1])
    _conv(out, net, 1, *ps[0], dd, dd, 1)
    k, chunk = cfg["num_detections"], cfg["dp_chunk"]
    p, d = cfg["dp_pooler"], cfg["dp_dim"]
    for c0 in range(0, k, chunk):                   # the head's chunks
        b = min(chunk, k - c0)
        for i in range(cfg["dp_convs"]):
            _conv(out, net, b, p, p, dd if i == 0 else d, d, 3)
        for o in (2,) + (cfg["num_patches"] + 1,) * 3:
            # ConvTranspose 4, stride 2: a 4x4 product a coarse position
            out.append(dict(kind="deconv", net=net,
                            ops=2 * b * p * p * 16 * d * o,
                            bytes=FP32 * b * (p * p * d + 4 * p * p * o)
                            + BF16 * 16 * d * o))
    return out


def request_sites(nets, photo_hw):
    """Every site of one demo request's three nets."""
    op, sc, dp = nets["openpose"], nets["schp"], nets["densepose"]
    return (openpose_sites(op, *openpose_input(op))
            + schp_sites(sc, sc["atr_classes"], sc["atr_size"])
            + schp_sites(sc, sc["lip_classes"], sc["lip_size"])
            + densepose_sites(dp, *densepose_input(dp, photo_hw)))


def request_ops(nets, photo_hw) -> int:
    return sum(s["ops"] for s in request_sites(nets, photo_hw))


# the program's conv kernels (#5, and #6 for one image of 32 MiB or more)
# take a 3x3 stride-1 conv padded 1 on each side, undilated, with input and
# output channels of at least 128, input channels a multiple of 32, output
# channels a multiple of 8 and a width of at least 8
def conv_kernel_site(s) -> bool:
    if s["kind"] != "conv" or s["k"] != 3 or s["stride"] != 1:
        return False
    if s["dilation"] != 1 or s["pad"] != 1:
        return False
    b, h, w, cin, cout = s["shape"]
    return (cin >= 128 and cout >= 128 and cin % 32 == 0 and cout % 8 == 0
            and w >= 8)


def conv_kernel_bound_s(nets, photo_hw, peak_ops, peak_bps) -> float:
    """Seconds the nets' conv-kernel sites need at the card's peaks: each
    site the larger of its operations over ``peak_ops`` and its bytes over
    ``peak_bps``."""
    return sum(max(s["ops"] / peak_ops, s["bytes"] / peak_bps)
               for s in request_sites(nets, photo_hw)
               if conv_kernel_site(s))
