"""The port's three preprocessing nets and its mask step against the
benchmark's plain fp32 reference (``benchmark/reference/preprocess.py``),
on the benchmark's seeded random weights at small input sizes on the CPU.

The nets are built by their own constructors at their published widths
and filled with ``reference.param_specs``' weights through
``common.load_into`` (which holds the port's parameter names and shapes to
the reference's); DensePose runs at the demo's tiny capacities (50 / 20
proposals, 4 detections). Both sides compute in fp32 on the CPU with the
same weights: the net comparisons allow 1e-4 relative, room for the
summation orders of two implementations (NHWC against NCHW convs, ROIAlign
as one gather against a gather a box), far under the bf16 rounding
(4e-3) a narrower path would add. The letterbox allows one uint8 level
(OpenCV's fixed-point bilinear against the reference's rounded float one),
the mask none. On the card (marker ``cuda``), OpenPose's device peaks
against the host's. This file imports no JAX."""

import json

import numpy as np
import pytest
import torch

from benchmark.harness import common
from benchmark.reference import preprocess as ref
from benchmark.reference import stack as S

SEED = 2_100_000_101
NET_TOL = 1e-4
CPU = torch.device("cpu")
CONFIG = common.BENCH / "configs" / "idmvton_demo_preprocess.json"


@pytest.fixture(scope="module", autouse=True)
def four_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def nets():
    cfg = json.loads(CONFIG.read_text())["nets"]
    cfg["densepose"].update(rpn_pre_nms_topk=50, rpn_post_nms_topk=20,
                            num_detections=4, dp_chunk=2)
    return cfg


def _weights(nets, component):
    spec = {component: ref.param_specs(nets)[component]}
    flat = common.make_weights(spec, SEED, CPU, dtype=torch.float32)
    if component == "densepose":
        ref.scale_draw_(flat)
    return flat


def _loaded(module, component, flat):
    common.load_into({component: module}, flat)
    return module


def rel(got, want):
    assert got.shape == want.shape
    return common.rel(got, want)


# ---------------------------------------------------------------------------
# OpenPose
# ---------------------------------------------------------------------------


def test_openpose_maps(nets):
    from idmvton_tpu_torch.preprocess.openpose import OpenPoseNet
    flat = _weights(nets, "openpose")
    net = _loaded(OpenPoseNet(device="cpu"), "openpose", flat)
    x = torch.rand(1, 64, 48, 3, generator=torch.Generator().manual_seed(1)
                   ) - 0.5
    with torch.no_grad(), S.fp32_mode():
        paf, heat = net(x, impl="torch")
        want_paf, want_heat = ref.openpose(S.Root(flat).sub("openpose"),
                                           nets["openpose"], x)
    assert paf.shape == (1, 8, 6, 38) and heat.shape == (1, 8, 6, 19)
    assert rel(paf, want_paf) < NET_TOL
    assert rel(heat, want_heat) < NET_TOL


# ---------------------------------------------------------------------------
# SCHP: letterbox, then the net's fusion logits at the input's size
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which,size", [("atr", 64), ("lip", 59)])
def test_schp_letterbox_and_logits(nets, which, size):
    from idmvton_tpu_torch.preprocess.schp import Parsing, SCHPNet
    comp = f"schp_{which}"
    classes = nets["schp"][f"{which}_classes"]
    flat = _weights(nets, comp)
    net = _loaded(SCHPNet(classes, device="cpu"), comp, flat)
    rng = np.random.default_rng(7)
    image = rng.integers(0, 256, (70, 52, 3), dtype=np.uint8)
    parsing = Parsing(net, net, device="cpu", impl="torch")
    x, meta = parsing.net_input(image, size)
    want_x, place = ref.letterbox(image, size)
    assert tuple(meta[:4]) == place
    # one uint8 level in SCHP's normalized units
    assert np.abs(x - want_x.numpy()).max() <= 1.0 / (255 * 0.224) + 1e-6
    with torch.no_grad(), S.fp32_mode():
        got = parsing.fusion_logits(net, x)
        fusion = ref.schp(S.Root(flat).sub(comp), nets["schp"],
                          torch.from_numpy(np.ascontiguousarray(x)))
        want = ref.bilinear(fusion, (size, size), True)
    assert got.shape == (1, size, size, classes)
    assert rel(got, want) < NET_TOL


# ---------------------------------------------------------------------------
# DensePose: features, box scores over its own proposals, the head on its
# own detections
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def densepose_run(nets):
    """The port's R-CNN on one preprocessed image, with what it produced:
    the FPN features, its two NMS calls (proposals and their person
    scores; detections) and its outputs."""
    from idmvton_tpu_torch.preprocess.densepose import rcnn
    from idmvton_tpu_torch.preprocess.densepose.rcnn import DensePoseConfig
    from idmvton_tpu_torch.preprocess.densepose.visualize import DensePose
    flat = _weights(nets, "densepose")
    dp = nets["densepose"]
    cfg = DensePoseConfig(rpn_pre_nms_topk=dp["rpn_pre_nms_topk"],
                          rpn_post_nms_topk=dp["rpn_post_nms_topk"],
                          num_detections=dp["num_detections"],
                          dp_chunk=dp["dp_chunk"])
    model = _loaded(rcnn.DensePoseRCNN(cfg, device="cpu"), "densepose", flat)
    wrapper = DensePose(model, short_edge=64, max_size=96, impl="torch")
    image = np.random.default_rng(3).integers(0, 256, (96, 72, 3),
                                              dtype=np.uint8)
    bgr, _ = wrapper._preprocess(image)
    calls = []
    nms = rcnn.nms_topk

    def tap(boxes, scores, **kw):
        out = nms(boxes, scores, **kw)
        calls.append({"scores": scores, "out": out})
        return out

    rcnn.nms_topk = tap
    record = {}
    try:
        with S.fp32_mode():
            out = wrapper.forward(bgr, record=record)
    finally:
        rcnn.nms_topk = nms
    x = torch.from_numpy(np.ascontiguousarray(bgr[None]))
    with torch.no_grad(), S.fp32_mode():
        ps = ref.resnet50_fpn(S.Root(flat).sub("densepose"), x)
    return {"flat": flat, "fpn": record["fpn"], "ref_fpn": ps,
            "nms": calls, "out": out}


def test_densepose_features(densepose_run):
    r = densepose_run
    assert len(r["fpn"]) == len(r["ref_fpn"]) == 5
    for got, want in zip(r["fpn"], r["ref_fpn"]):
        assert rel(got, want) < NET_TOL


def test_densepose_box_scores_over_its_proposals(nets, densepose_run):
    r = densepose_run
    rpn, det = r["nms"]
    boxes, _, idx = rpn["out"]
    valid = idx >= 0
    assert int(valid.sum()) > 0
    w = S.Root(r["flat"]).sub("densepose")
    with torch.no_grad(), S.fp32_mode():
        want = ref.box_scores(w, nets["densepose"], r["ref_fpn"],
                              boxes[valid])
    assert rel(det["scores"][valid], want) < NET_TOL


@pytest.mark.parametrize("output", ["coarse", "fine", "u", "v"])
def test_densepose_head_on_its_detections(nets, densepose_run, output):
    r = densepose_run
    out = r["out"]
    kept = out["valid"]
    assert int(kept.sum()) > 0
    w = S.Root(r["flat"]).sub("densepose")
    with torch.no_grad(), S.fp32_mode():
        head = ref.densepose_head(w, nets["densepose"],
                                  ref.decoder(w, r["ref_fpn"]),
                                  out["boxes"][kept])
    assert out[output].shape[1:3] == (112, 112)
    assert rel(out[output][kept], head[output]) < NET_TOL


# ---------------------------------------------------------------------------
# the mask step, on shared labels and keypoints
# ---------------------------------------------------------------------------


def _parse():
    """A 384x512 ATR label map with LIP's neck: background, head, neck,
    upper clothes with a hole, both arms, pants, shoes, a bag."""
    p = np.zeros((512, 384), np.uint8)
    p[40:120, 150:230] = 11          # head
    p[120:140, 170:210] = 18         # neck
    p[140:300, 120:260] = 4          # upper clothes
    p[200:210, 180:190] = 0          # a hole in them
    p[150:320, 80:120] = 14          # left arm (image right)
    p[150:320, 260:300] = 15         # right arm
    p[300:470, 130:250] = 6          # pants
    p[470:500, 130:180] = 9
    p[470:500, 200:250] = 10
    p[250:300, 300:340] = 16         # bag
    return p


def _keypoints(wrists=True):
    kp = -np.ones((18, 2), np.float32)
    kp[1] = (190, 140)
    kp[2], kp[3], kp[4] = (255, 150), (280, 230), (285, 310)
    kp[5], kp[6], kp[7] = (125, 150), (100, 230), (95, 310)
    if not wrists:
        kp[4] = (0.0, 0.0)
    return {"pose_keypoints_2d": kp.reshape(-1).tolist()}


@pytest.mark.parametrize("wrists", [True, False], ids=["wrists", "no_right"])
def test_mask_location(wrists):
    from idmvton_tpu_torch.preprocess.agnostic_mask import get_mask_location
    parse, kp = _parse(), _keypoints(wrists)
    got, _ = get_mask_location("hd", "upper_body", parse, kp)
    want = ref.mask_location(parse, kp)
    got = np.asarray(got)
    assert got.shape == want.shape == (512, 384)
    assert 0 < int((want > 0).sum()) < want.size
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# on the card: OpenPose's peaks found on the device equal the host's
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_find_peaks_on_the_card_equals_the_host():
    """The peaks found on the card against the reference's per-part scipy
    loop (body.py) on the host, to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from scipy.ndimage import gaussian_filter

    from idmvton_tpu_torch.preprocess.openpose import find_peaks

    def host_peaks(heatmap, threshold=0.1):
        out, counter = [], 0
        for part in range(18):
            m = gaussian_filter(heatmap[:, :, part], sigma=3.0)
            pad = np.pad(m, 1)
            is_peak = ((m >= pad[:-2, 1:-1]) & (m >= pad[2:, 1:-1])
                       & (m >= pad[1:-1, :-2]) & (m >= pad[1:-1, 2:])
                       & (m > threshold))
            ys, xs = np.nonzero(is_peak)
            out.append([(int(x), int(y), float(heatmap[y, x, part]),
                         counter + i) for i, (y, x) in enumerate(zip(ys, xs))])
            counter += len(ys)
        return out

    rng = np.random.default_rng(11)
    for scale in (0.2, 1.0):
        heat = (rng.random((512, 384, 19)) * scale).astype(np.float32)
        heat = np.stack([gaussian_filter(heat[..., c], 2.0)
                         for c in range(19)], -1)
        got = find_peaks(torch.from_numpy(heat).cuda())
        assert sum(len(p) for p in got) > 0
        assert got == host_peaks(heat)
