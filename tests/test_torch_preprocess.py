"""The port's preprocessing front-end against the JAX package's, on the CPU.

NMS, ROIAlign, anchors and box transforms; the three nets (OpenPose, SCHP,
the DensePose R-CNN) on JAX's own parameter trees at small inputs, fp32;
the host decode and postprocessing (``find_peaks`` and the keypoints,
``refine_cloth``, ``paint_segmentation``, ``get_mask_location``) and the
ONNX reader bit for bit on the same inputs, the latter also on a
hand-encoded protobuf; every ``convert_*`` against JAX's on state dicts
exported from JAX's init (and SCHP's three ONNX export shapes).

The trees get random biases, norm affines and (SCHP) batch-norm
statistics, so a dropped or misplaced term shows. JAX runs op by op
(``jax.disable_jit``), cheaper on the CPU than compiling each net.

Tolerances: continuous outputs (features, logits, maps, boxes) within
1e-4 relative to their largest magnitude: fp32 on both sides, the same
formulas, other summation orders. Discrete outputs (NMS keeps, top-k
orders, labels, keypoints) are equal: where a near-tie could flip one, the
test says so beside its bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idmvton_tpu.ops import nms as jnms
from idmvton_tpu.ops.roi_align import roi_align as j_roi_align
from idmvton_tpu.preprocess import agnostic_mask as jmask
from idmvton_tpu.preprocess import openpose as jop
from idmvton_tpu.preprocess import schp as jschp
from idmvton_tpu.preprocess.densepose import convert as jdconv
from idmvton_tpu.preprocess.densepose import rcnn as jrcnn
from idmvton_tpu.preprocess.densepose import visualize as jvis
from idmvton_tpu.weights import onnx_reader as jonnx
from idmvton_tpu_torch.ops import nms as tnms
from idmvton_tpu_torch.ops import roi_align as troi
from idmvton_tpu_torch.preprocess import agnostic_mask as tmask
from idmvton_tpu_torch.preprocess import openpose as top
from idmvton_tpu_torch.preprocess import schp as tschp
from idmvton_tpu_torch.preprocess.densepose import convert as tdconv
from idmvton_tpu_torch.preprocess.densepose import rcnn as trcnn
from idmvton_tpu_torch.preprocess.densepose import visualize as tvis
from idmvton_tpu_torch.weights import onnx_reader as tonnx
from idmvton_tpu_torch.weights.from_jax import load_module_params
from test_agnostic_mask import keypoints as mask_keypoints
from test_agnostic_mask import synthetic_parse

TOL = 1e-4
DP_CFG = dict(rpn_pre_nms_topk=50, rpn_post_nms_topk=20, num_detections=4,
              dp_chunk=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _perturb(tree, seed):
    """Random conv / linear biases ~ N(0, 0.1^2), norm scales ~ 1 + N(0,
    0.1^2) and shifts, and (SCHP) batch-norm means ~ N(0, 0.1^2) and
    variances ~ U(0.5, 1.5): every leaf the init leaves trivial."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            out = {}
            for k in t:
                v = t[k]
                if isinstance(v, (dict, list)):
                    out[k] = walk(v)
                elif k in ("bias", "mean"):
                    out[k] = (rng.standard_normal(v.shape) * 0.1).astype(
                        v.dtype)
                elif k == "scale":
                    out[k] = (1 + rng.standard_normal(v.shape) * 0.1).astype(
                        v.dtype)
                elif k == "var":
                    out[k] = rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)
                else:
                    out[k] = v
            return out
        return [walk(v) for v in t]

    return walk(tree)


# ---------------------------------------------------------------------------
# NMS, ROIAlign, anchors and box transforms
# ---------------------------------------------------------------------------


def _boxes(n, seed, ties=False):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 40, (n, 2))
    sizes = rng.uniform(2, 14, (n, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2],
                           1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    if ties:   # equal scores: the order must break them as JAX does
        scores = np.round(scores * 4) / 4
    return boxes, scores


def test_box_iou_matches_jax():
    a, _ = _boxes(30, 0)
    b, _ = _boxes(20, 1)
    _close(tnms.box_iou(torch.from_numpy(a), torch.from_numpy(b)),
           jnms.box_iou(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("thr,score_thr", [(0.5, float("-inf")),
                                           (0.3, 0.4)])
def test_nms_matches_jax(ties, thr, score_thr):
    boxes, scores = _boxes(60, 2, ties)
    kw = dict(iou_threshold=thr, score_threshold=score_thr)
    want = np.asarray(jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                    **kw))
    got = tnms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                        **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    for topk in (10, 80):   # fewer than kept, more than the boxes (padded)
        wb, ws, wi = jnms.nms_topk(jnp.asarray(boxes), jnp.asarray(scores),
                                   topk=topk, **kw)
        gb, gs, gi = tnms.nms_topk(torch.from_numpy(boxes),
                                   torch.from_numpy(scores), topk=topk, **kw)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("out,ratio,scale", [(7, 2, 1.0), (4, 1, 0.25),
                                             (5, 3, 0.5)])
def test_roi_align_matches_jax(out, ratio, scale):
    rng = np.random.default_rng(3)
    feat = rng.standard_normal((2, 16, 20, 5)).astype(np.float32)
    boxes = np.array([[2.0, 3.0, 14.0, 11.0], [0.0, 0.0, 80.0, 64.0],
                      [5.5, 2.5, 9.0, 13.0], [-8.0, -4.0, 30.0, 90.0],
                      [1.0, 1.0, 1.0, 1.0]], np.float32) / scale * 0.25
    idx = np.array([0, 1, -1, 1, 0], np.int32)
    kw = dict(output_size=out, spatial_scale=scale, sampling_ratio=ratio)
    want = j_roi_align(jnp.asarray(feat), jnp.asarray(boxes),
                          jnp.asarray(idx), **kw)
    got = troi.roi_align(torch.from_numpy(feat), torch.from_numpy(boxes),
                         torch.from_numpy(idx), **kw)
    _close(got, want)
    assert np.all(got[2].numpy() == 0)


def test_anchors_deltas_levels_match_jax():
    for args in (((2, 3), 4, 32, (0.5, 1.0, 2.0)), ((5, 7), 16, 128,
                                                    (0.5, 1.0, 2.0))):
        np.testing.assert_array_equal(trcnn.make_anchors(*args),
                                      jrcnn.make_anchors(*args))
    rng = np.random.default_rng(4)
    anchors = trcnn.make_anchors((6, 5), 8, 64, (0.5, 1.0, 2.0))
    deltas = (rng.standard_normal(anchors.shape) * 2).astype(np.float32)
    deltas[:3, 2:] = 9.0   # past the log(1000/16) clamp
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        want = jrcnn.apply_deltas(jnp.asarray(anchors), jnp.asarray(deltas),
                                  w)
        got = trcnn.apply_deltas(torch.from_numpy(anchors),
                                 torch.from_numpy(deltas), w)
        _close(got, want)
        _close(trcnn.clip_boxes(got, (30, 25)),
               jrcnn._clip_boxes(want, (30, 25)))
        np.testing.assert_array_equal(
            trcnn.fpn_level_assign(got).numpy(),
            np.asarray(jrcnn._fpn_level_assign(want)))
    scores = np.round(rng.uniform(0, 1, 50) * 5).astype(np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(scores), 20)
    gv, gi = trcnn.top_k(torch.from_numpy(scores), 20)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_deconv2x_matches_jax():
    """ConvTranspose2d(k=4, s=2, p=1) on the HWIO kernel against JAX's
    input-dilated conv with the flipped kernel (the kernel flip)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 6, 8)).astype(np.float32)
    p = {"kernel": rng.standard_normal((4, 4, 8, 3)).astype(np.float32),
         "bias": rng.standard_normal(3).astype(np.float32)}
    conv = torch.nn.Module()
    conv.kernel, conv.bias = (torch.from_numpy(p[k]) for k in ("kernel",
                                                               "bias"))
    want = jrcnn._deconv2x(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    _close(trcnn.deconv2x(conv, torch.from_numpy(x)), want)


# ---------------------------------------------------------------------------
# the three nets on JAX's trees
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def openpose_pair():
    tree = _perturb(_np_tree(jop.init_openpose(jax.random.PRNGKey(0))), 10)
    net = top.OpenPoseNet(device="cpu")
    load_module_params(net, tree)
    return tree, net


def test_openpose_net_matches_jax(openpose_pair):
    tree, net = openpose_pair
    x = np.random.default_rng(6).uniform(-0.5, 0.5, (1, 32, 40, 3)).astype(
        np.float32)
    with jax.disable_jit():
        wp, wh = jop.openpose_apply(jax.tree.map(jnp.asarray, tree),
                                    jnp.asarray(x))
    with torch.no_grad():
        gp, gh = net(torch.from_numpy(x))
    _close(gp, wp)
    _close(gh, wh)


def test_openpose_wrapper_matches_jax(openpose_pair, monkeypatch):
    """``OpenPose.__call__`` on a 96x72 image: the x8-upsampled maps
    (device bilinear against ``jax.image.resize``) within 1e-4, and the
    keypoints equal (the decode is the same host code on those maps; a
    peak whose smoothed value sits within 1e-4 of a neighbour's could flip
    one, which this image does not have)."""
    tree, net = openpose_pair
    img = np.random.default_rng(7).integers(0, 255, (96, 72, 3), np.uint8)
    jpose = jop.OpenPose(jax.tree.map(jnp.asarray, tree), boxsize=64)
    monkeypatch.setattr(jpose, "_apply", jop.openpose_apply)
    tpose = top.OpenPose(net, boxsize=64)
    with jax.disable_jit():
        wpaf, wheat = jpose.heatmaps(img[:, :, ::-1])
        want = jpose(img)
    gpaf, gheat = tpose.heatmaps(img[:, :, ::-1])
    _close(gpaf, wpaf)
    _close(gheat, wheat)
    assert tpose(img) == want


def test_find_peaks_and_keypoints_match_jax():
    """The decode on one set of maps: two synthetic people's peaks and
    limbs, equal on both sides."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(8)
    heat = np.zeros((64, 48, 19), np.float32)
    paf = rng.standard_normal((64, 48, 38)).astype(np.float32) * 0.01
    for part in range(18):
        for cx in (12, 34):
            heat[8 + 2 * part, cx + part % 3, part] = 50.0
    heat = np.stack([gaussian_filter(heat[..., c], 1.0) for c in range(19)],
                    -1)
    peaks = top.find_peaks(heat)
    assert peaks == jop.find_peaks(heat)
    conns = top.match_limbs(paf, peaks, img_h=64)
    assert conns == jop.match_limbs(paf, peaks, img_h=64)
    sub_t, cand_t = top.assemble_people(peaks, conns)
    sub_j, cand_j = jop.assemble_people(peaks, conns)
    np.testing.assert_array_equal(sub_t, sub_j)
    np.testing.assert_array_equal(cand_t, cand_j)


@pytest.fixture(scope="module")
def schp_pair():
    tree = _perturb(_np_tree(jschp.init_schp(jax.random.PRNGKey(0),
                                             jschp.LIP_CLASSES)), 11)
    net = tschp.SCHPNet(jschp.LIP_CLASSES, device="cpu")
    load_module_params(net, tree)
    return tree, net


def test_schp_net_matches_jax(schp_pair):
    tree, net = schp_pair
    x = np.random.default_rng(9).standard_normal((1, 48, 40, 3)).astype(
        np.float32)
    with jax.disable_jit():
        want = jschp.schp_apply(jax.tree.map(jnp.asarray, tree),
                                jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("hw,out", [((5, 7), (20, 21)), ((6, 6), (6, 6)),
                                    ((1, 4), (3, 9))])
def test_schp_resize_and_pool_match_jax(hw, out):
    x = np.random.default_rng(10).standard_normal((2, *hw, 3)).astype(
        np.float32)
    _close(tschp._resize_bilinear(torch.from_numpy(x), out),
           jschp._resize_bilinear(jnp.asarray(x), out))
    for size in (1, 2, 3):
        _close(tschp.adaptive_avg_pool(torch.from_numpy(x), size),
               jschp.adaptive_avg_pool(jnp.asarray(x), size))


def test_parsing_labels_match_jax(schp_pair, monkeypatch):
    """``Parsing`` on a 64x48 image with the LIP tree as both nets (the
    ATR head's width is the only difference): the letterboxed fusion
    logits within 1e-4 and the labels equal (an argmax within 1e-4 of a
    tie could flip a pixel; this image has none)."""
    tree, net = schp_pair
    img = np.random.default_rng(12).integers(0, 255, (64, 48, 3), np.uint8)
    jt = jax.tree.map(jnp.asarray, tree)
    jparse = jschp.Parsing(jt, jt)
    monkeypatch.setattr(jparse, "_apply", jschp.schp_apply)
    tparse = tschp.Parsing(net, net)
    with jax.disable_jit():
        want_logits = jparse._logits(jt, img, 40)
        want_img, want_face = jparse(img)
    _close(tparse._logits(net, img, 40), want_logits)
    got_img, got_face = tparse(img)
    np.testing.assert_array_equal(np.asarray(got_img), np.asarray(want_img))
    assert got_img.getpalette() == want_img.getpalette()
    np.testing.assert_array_equal(got_face, want_face)


@pytest.fixture(scope="module")
def densepose_pair():
    cfg_j = jrcnn.DensePoseConfig(**DP_CFG)
    tree = _perturb(_np_tree(jrcnn.init_densepose_rcnn(
        jax.random.PRNGKey(0), cfg_j)), 13)
    # the stem scaled to mean-subtracted pixels (|x| ~ 50): the init's
    # fan-in scale on them saturates the random box head (no detections)
    stem = tree["backbone"]["stem"]["conv"]
    stem["kernel"] = stem["kernel"] / np.float32(50.0)
    model = trcnn.DensePoseRCNN(trcnn.DensePoseConfig(**DP_CFG),
                                device="cpu")
    load_module_params(model, tree)
    return cfg_j, tree, model


def test_densepose_rcnn_matches_jax(densepose_pair):
    """The R-CNN on a 64x96 input: FPN features, the pre-NMS RPN scores,
    the detections and the densepose head's outputs. NMS keeps and the
    detection order are equal (a score or IoU within 1e-4 of a threshold
    could flip one; these random weights give none)."""
    cfg_j, tree, model = densepose_pair
    x = np.random.default_rng(14).standard_normal((1, 64, 96, 3)).astype(
        np.float32) * 50
    jt = jax.tree.map(jnp.asarray, tree)
    with jax.disable_jit():
        want = jrcnn.densepose_rcnn_apply(jt, jnp.asarray(x), cfg_j)
        jps = jrcnn.fpn_apply(jt["fpn"], jrcnn.resnet50_apply(
            jt["backbone"], jnp.asarray(x)))
    record = {}
    with torch.no_grad():
        got = model(torch.from_numpy(x), record=record)
    for g, w in zip(record["fpn"], jps):
        _close(g, w)
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(want["valid"]))
    assert got["valid"].any()
    for k in ("boxes", "scores", "coarse", "fine", "u", "v"):
        _close(got[k], want[k])
    glab, guv = tvis.extract_iuv(got["coarse"], got["fine"], got["u"],
                                 got["v"])
    wlab, wuv = jvis.extract_iuv(want["coarse"], want["fine"], want["u"],
                                 want["v"])
    np.testing.assert_array_equal(glab.numpy(), np.asarray(wlab))
    _close(guv, wuv)


def test_dp_head_chunking_is_exact(densepose_pair):
    """The head over chunks of 2 equals it unchunked."""
    _, _, model = densepose_pair
    dpp = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (4, 28, 28, 256)).astype(np.float32))
    with torch.no_grad():
        chunked = model._dp_head(dpp)
        model.cfg = trcnn.DensePoseConfig(**dict(DP_CFG, dp_chunk=4))
        try:
            whole = model._dp_head(dpp)
        finally:
            model.cfg = trcnn.DensePoseConfig(**DP_CFG)
    for k in whole:
        torch.testing.assert_close(chunked[k], whole[k], rtol=1e-5,
                                   atol=1e-5)


def test_densepose_wrapper_matches_jax(densepose_pair, monkeypatch):
    """``DensePose.__call__`` (resize, BGR mean, R-CNN, painting) on a
    96x72 image at short edge 64: the painted image equal."""
    cfg_j, tree, model = densepose_pair
    img = np.random.default_rng(16).integers(0, 255, (96, 72, 3), np.uint8)
    jdp = jvis.DensePose(jax.tree.map(jnp.asarray, tree), cfg_j,
                         short_edge=64, max_size=96)
    monkeypatch.setattr(jdp, "_apply", lambda p, x: jrcnn.
                        densepose_rcnn_apply(p, x, cfg_j))
    tdp = tvis.DensePose(model, short_edge=64, max_size=96)
    with jax.disable_jit():
        want = jdp(img)
    got = tdp(img)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# host postprocessing, bit for bit
# ---------------------------------------------------------------------------


def test_refine_cloth_add_neck_palette_match_jax():
    parse = synthetic_parse().astype(np.int64)
    parse[200:215, 170:190] = 0      # a hole in the upper cloth
    parse[150:160, 100:125] = 4      # cloth inside an arm
    lip = np.zeros_like(parse)
    lip[40:100, 160:230] = 13
    np.testing.assert_array_equal(tschp.refine_cloth(parse),
                                  jschp.refine_cloth(parse))
    np.testing.assert_array_equal(tschp.add_neck(parse, lip),
                                  jschp.add_neck(parse, lip))
    assert tschp.get_palette(19) == jschp.get_palette(19)


def test_paint_and_extract_match_jax():
    rng = np.random.default_rng(17)
    img = rng.integers(0, 255, (80, 60, 3), np.uint8)
    labels = rng.integers(0, 25, (3, 16, 16)).astype(np.uint8)
    uv = rng.uniform(0, 1, (3, 16, 16, 2)).astype(np.float32)
    boxes = np.array([[5, 4, 40, 70], [-3, 10, 30, 95], [20, 20, 20, 30]],
                     np.float32)
    scores = np.array([0.9, 0.5, 0.3], np.float32)
    valid = np.array([True, True, False])
    out = {"boxes": boxes, "labels": labels, "uv": uv, "valid": valid,
           "scores": scores}
    for spec in tvis.VISUALIZERS:
        np.testing.assert_array_equal(
            tvis.VISUALIZERS[spec](img.copy(), out),
            jvis.VISUALIZERS[spec](img.copy(), out), err_msg=spec)
    coarse, fine, u, v = (rng.standard_normal((3, 8, 8, c)).astype(
        np.float32) for c in (2, 25, 25, 25))
    gl, guv = tvis.extract_iuv(*(torch.from_numpy(a) for a in
                                 (coarse, fine, u, v)))
    wl, wuv = jvis.extract_iuv(coarse, fine, u, v)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(guv.numpy(), np.asarray(wuv))


@pytest.mark.parametrize("category", ["upper_body", "lower_body",
                                      "dresses"])
@pytest.mark.parametrize("model_type", ["hd", "dc"])
def test_get_mask_location_matches_jax(category, model_type):
    from PIL import Image
    parse = synthetic_parse()
    kp = mask_keypoints()
    for p in (parse, Image.fromarray(parse).resize((192, 256))):
        got = tmask.get_mask_location(model_type, category, p, kp)
        want = jmask.get_mask_location(model_type, category, p, kp)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ---------------------------------------------------------------------------
# the ONNX reader and the converters
# ---------------------------------------------------------------------------


def _varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num, wire, payload):
    key = _varint(num << 3 | wire)
    if wire == 0:
        return key + _varint(payload)
    return key + _varint(len(payload)) + payload


def _tensor_proto(name, arr, raw=True):
    """A TensorProto: dims, data_type, name and raw_data (or float_data /
    int64_data, packed)."""
    code = {np.dtype(np.float32): 1, np.dtype(np.int64): 7}[arr.dtype]
    out = b"".join(_field(1, 0, d) for d in arr.shape)
    out += _field(2, 0, code) + _field(8, 2, name.encode())
    if raw:
        out += _field(9, 2, arr.tobytes())
    elif code == 1:
        out += _field(4, 2, arr.astype("<f4").tobytes())
    else:
        out += _field(7, 2, b"".join(_varint(int(v) & (2**64 - 1))
                                     for v in arr.ravel()))
    return out


def _onnx_model(initializers, nodes, raw=True):
    """A ModelProto with one GraphProto: nodes (op, name, inputs,
    outputs), initializers {name: array}, one graph input and output."""
    graph = []
    for op, name, ins, outs in nodes:
        node = b"".join(_field(1, 2, i.encode()) for i in ins)
        node += b"".join(_field(2, 2, o.encode()) for o in outs)
        node += _field(3, 2, name.encode()) + _field(4, 2, op.encode())
        graph.append(_field(1, 2, node))
    for name, arr in initializers.items():
        graph.append(_field(5, 2, _tensor_proto(name, arr, raw)))
    graph.append(_field(11, 2, _field(1, 2, b"input")))
    graph.append(_field(12, 2, _field(1, 2, b"output")))
    return _field(1, 0, 8) + _field(7, 2, b"".join(graph))


def _same_model(got, want):
    assert list(got.initializers) == list(want.initializers)
    for k in want.initializers:
        g, w = got.initializers[k], want.initializers[k]
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got.nodes == want.nodes
    assert got.graph_inputs == want.graph_inputs
    assert got.graph_outputs == want.graph_outputs


@pytest.mark.parametrize("raw", [True, False])
def test_onnx_reader_matches_jax_on_hand_encoded_model(tmp_path, raw):
    rng = np.random.default_rng(18)
    inits = {"w": rng.standard_normal((4, 3, 3, 3)).astype(np.float32),
             "b": rng.standard_normal(4).astype(np.float32),
             "shape": np.array([1, -1, 7], np.int64)}
    nodes = [("Conv", "c0", ("input", "w", "b"), ("h",)),
             ("Reshape", "r0", ("h", "shape"), ("output",))]
    path = tmp_path / "m.onnx"
    path.write_bytes(_onnx_model(inits, nodes, raw))
    got, want = tonnx.read_onnx(str(path)), jonnx.read_onnx(str(path))
    _same_model(got, want)
    np.testing.assert_array_equal(got.initializers["w"], inits["w"])
    np.testing.assert_array_equal(got.initializers["shape"], inits["shape"])
    assert got.nodes[0].inputs == ("input", "w", "b")


def _same_tree(got, want):
    """A port tree (torch) equal to a JAX tree, leaf for leaf."""
    if isinstance(want, dict):
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k in want:
            _same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_tree(g, w)
    else:
        w = np.asarray(want)
        assert got.dtype == torch.float32 and tuple(got.shape) == w.shape
        np.testing.assert_array_equal(got.numpy(), w)


def _torch_conv(p):
    return np.ascontiguousarray(np.transpose(np.asarray(p["kernel"]),
                                             (3, 2, 0, 1)))


def _schp_state_dict(tree):
    """The torch (AugmentCE2P) state dict of a JAX SCHP tree."""
    sd = {}

    def conv(key, p):
        sd[key + ".weight"] = _torch_conv(p)
        if "bias" in p:
            sd[key + ".bias"] = np.asarray(p["bias"])

    def bn(key, p):
        for ours, theirs in (("scale", "weight"), ("bias", "bias"),
                             ("mean", "running_mean"),
                             ("var", "running_var")):
            sd[f"{key}.{theirs}"] = np.asarray(p[ours])

    def conv_bn(ck, bk, p):
        conv(ck, p["conv"])
        bn(bk, p["bn"])

    for i, p in enumerate(tree["stem"]):
        conv_bn(f"conv{i + 1}", f"bn{i + 1}", p)
    for li in range(4):
        for bi, blk in enumerate(tree[f"layer{li + 1}"]):
            pre = f"layer{li + 1}.{bi}"
            for j in (1, 2, 3):
                conv_bn(f"{pre}.conv{j}", f"{pre}.bn{j}", blk[f"conv{j}"])
            if "downsample" in blk:
                conv_bn(f"{pre}.downsample.0", f"{pre}.downsample.1",
                        blk["downsample"])
    for i, p in enumerate(tree["psp"]["stages"]):
        conv_bn(f"context_encoding.stages.{i}.1",
                f"context_encoding.stages.{i}.2", p)
    conv_bn("context_encoding.bottleneck.0", "context_encoding.bottleneck.1",
            tree["psp"]["bottleneck"])
    e, d, f = tree["edge"], tree["decoder"], tree["fusion"]
    for k in (1, 2, 3):
        conv_bn(f"edge.conv{k}.0", f"edge.conv{k}.1", e[f"conv{k}"])
    conv("edge.conv4", e["conv4"])
    conv("edge.conv5", e["conv5"])
    conv_bn("decoder.conv1.0", "decoder.conv1.1", d["conv1"])
    conv_bn("decoder.conv2.0", "decoder.conv2.1", d["conv2"])
    conv_bn("decoder.conv3.0", "decoder.conv3.1", d["conv3a"])
    conv_bn("decoder.conv3.2", "decoder.conv3.3", d["conv3b"])
    conv("decoder.conv4", d["conv4"])
    conv_bn("fushion.0", "fushion.1", f["conv"])
    conv("fushion.3", f["out"])
    return sd


def test_convert_openpose_matches_jax(openpose_pair, tmp_path):
    """Both converters on the state dict, and ``OpenPose.from_torch`` on
    it saved as a .pth: the net's parameters are the tree's."""
    tree, _ = openpose_pair
    sd = {}
    for block, layers in tree.items():
        for name, p in layers.items():
            sd[f"{block}.{name}.weight"] = _torch_conv(p)
            sd[f"{block}.{name}.bias"] = np.asarray(p["bias"])
    want = jop.convert_openpose(sd, strict=True)
    got = top.convert_openpose(
        {k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    _same_tree(got, want)
    _same_tree(got, tree)
    path = tmp_path / "body_pose_model.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    net = top.OpenPose.from_torch(str(path), device="cpu").net
    np.testing.assert_array_equal(
        net.model6_2.Mconv7_stage6_L2.kernel.numpy(),
        tree["model6_2"]["Mconv7_stage6_L2"]["kernel"])
    sd["model0.extra.weight"] = sd["model0.conv1_1.bias"]
    with pytest.raises(ValueError, match="unconsumed"):
        top.convert_openpose(sd, strict=True)


def test_convert_schp_matches_jax(schp_pair):
    tree, _ = schp_pair
    sd = {"module." + k: v for k, v in _schp_state_dict(tree).items()}
    want = jschp.convert_schp(sd, jschp.LIP_CLASSES, strict=True)
    got = tschp.convert_schp(sd, tschp.LIP_CLASSES, strict=True)
    _same_tree(got, want)
    _same_tree(got, tree)


def _schp_onnx(tmp_path, sd, name, *, anonymous=False, folded=False):
    """An ONNX file of SCHP's weights in the trace order of
    ``_trace_order``: Conv nodes (a BN-folded export: conv biases, no
    BatchNormalization nodes) and BatchNormalization nodes, the shared
    edge.conv4 applied three times; ``anonymous`` renames every
    initializer."""
    order = jschp._trace_order(jschp.LIP_CLASSES)
    inits, nodes, rename = {}, [], {}

    def init(key):
        rename.setdefault(key, f"onnx::{len(rename)}" if anonymous else key)
        inits[rename[key]] = sd[key].astype(np.float32)
        return rename[key]

    conv4_uses = 0
    for kind, key in order:
        if kind == "bn" and folded:
            continue
        if kind == "conv":
            ins = ["x", init(key + ".weight")]
            if key + ".bias" in sd or folded:
                if key + ".bias" not in sd:
                    sd[key + ".bias"] = np.zeros(
                        sd[key + ".weight"].shape[0], np.float32)
                ins.append(init(key + ".bias"))
            reps = 3 if key == "edge.conv4" else 1
            for _ in range(reps):
                nodes.append(("Conv", f"n{len(nodes)}", tuple(ins), ("y",)))
                conv4_uses += key == "edge.conv4"
        else:
            ins = ["x"] + [init(f"{key}.{s}") for s in
                           ("weight", "bias", "running_mean", "running_var")]
            nodes.append(("BatchNormalization", f"n{len(nodes)}",
                          tuple(ins), ("y",)))
    inits["shape_const"] = np.array([1, 2], np.int64)
    path = tmp_path / name
    path.write_bytes(_onnx_model(inits, nodes))
    return str(path)


@pytest.mark.parametrize("export", ["named", "anonymous", "folded"])
def test_convert_schp_onnx_matches_jax(schp_pair, tmp_path, export):
    """The three export shapes through both ONNX converters, trees equal;
    the folded export's tree (conv biases, identity batch norms) fills an
    ``SCHPNet`` through ``schp_from_tree``."""
    tree, _ = schp_pair
    sd = _schp_state_dict(tree)
    path = _schp_onnx(tmp_path, sd, f"{export}.onnx",
                      anonymous=export == "anonymous",
                      folded=export == "folded")
    want = jschp.convert_schp_onnx(path, jschp.LIP_CLASSES)
    got = tschp.convert_schp_onnx(path, tschp.LIP_CLASSES)
    _same_tree(got, want)
    if export != "folded":
        _same_tree(got, tree)
    else:
        net = tschp.schp_from_tree(got, tschp.LIP_CLASSES, device="cpu")
        assert net.stem[0].conv.bias is not None
        assert net.edge.conv4.bias is not None


def _densepose_state_dict(tree, rng):
    """A d2 state dict with the shapes of a JAX DensePose tree: its conv
    and linear weights in the torch layouts, and random frozen-BN
    statistics (folded, they give the tree's own scale and bias)."""
    sd = {}

    def conv(key, p):
        sd[key + ".weight"] = _torch_conv(p)
        if "bias" in p:
            sd[key + ".bias"] = np.asarray(p["bias"])

    def conv_bn(key, p):
        conv(key, p["conv"])
        n = p["bn"]["scale"].shape[0]
        for s in ("weight", "bias", "running_mean"):
            sd[f"{key}.norm.{s}"] = rng.standard_normal(n).astype(np.float32)
        sd[f"{key}.norm.running_var"] = rng.uniform(0.5, 1.5, n).astype(
            np.float32)

    bb = tree["backbone"]
    conv_bn("backbone.bottom_up.stem.conv1", bb["stem"])
    for li in range(4):
        for bi, blk in enumerate(bb[f"res{li + 2}"]):
            pre = f"backbone.bottom_up.res{li + 2}.{bi}"
            for j in (1, 2, 3):
                conv_bn(f"{pre}.conv{j}", blk[f"conv{j}"])
            if "shortcut" in blk:
                conv_bn(f"{pre}.shortcut", blk["shortcut"])
    for i in range(4):
        conv(f"backbone.fpn_lateral{i + 2}", tree["fpn"]["lateral"][i])
        conv(f"backbone.fpn_output{i + 2}", tree["fpn"]["output"][i])
    for ours, theirs in (("conv", "conv"), ("objectness",
                                            "objectness_logits"),
                         ("deltas", "anchor_deltas")):
        conv(f"proposal_generator.rpn_head.{theirs}", tree["rpn"][ours])
    bh = tree["box_head"]
    w1 = np.asarray(bh["fc1"]["kernel"]).T.reshape(1024, 7, 7, 256)
    sd["roi_heads.box_head.fc1.weight"] = np.ascontiguousarray(
        w1.transpose(0, 3, 1, 2).reshape(1024, -1))
    sd["roi_heads.box_head.fc1.bias"] = np.asarray(bh["fc1"]["bias"])
    for ours, theirs in (("fc2", "box_head.fc2"),
                         ("cls", "box_predictor.cls_score"),
                         ("reg", "box_predictor.bbox_pred")):
        sd[f"roi_heads.{theirs}.weight"] = np.ascontiguousarray(
            np.asarray(bh[ours]["kernel"]).T)
        sd[f"roi_heads.{theirs}.bias"] = np.asarray(bh[ours]["bias"])
    dp = tree["dp_head"]
    for i, p in enumerate(dp["convs"]):
        conv(f"roi_heads.densepose_head.body_conv_fcn{i + 1}", p)
    for ours, theirs in (("coarse_segm", "ann_index_lowres"),
                         ("fine_segm", "index_uv_lowres"),
                         ("u", "u_lowres"), ("v", "v_lowres")):
        key = f"roi_heads.densepose_predictor.{theirs}"
        sd[key + ".weight"] = np.ascontiguousarray(np.transpose(
            np.asarray(dp[ours]["kernel"]), (2, 3, 0, 1)))
        sd[key + ".bias"] = np.asarray(dp[ours]["bias"])
    for lvl, convs in enumerate(tree["decoder"]["scale_heads"]):
        for j, p in enumerate(convs):
            conv(f"roi_heads.decoder.p{lvl + 2}.{2 * j}", p)
    conv("roi_heads.decoder.predictor", tree["decoder"]["predictor"])
    sd["pixel_mean"] = np.zeros(3, np.float32)
    return sd


def test_convert_densepose_matches_jax(densepose_pair, tmp_path):
    """A d2 pickle through ``load_d2_pickle`` and both converters: trees
    equal, the conv / linear leaves equal to the source tree's, and the
    tree fills a ``DensePoseRCNN``."""
    import pickle
    cfg_j, tree, _ = densepose_pair
    sd = _densepose_state_dict(tree, np.random.default_rng(19))
    path = tmp_path / "model.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": sd, "__author__": "test"}, f)
    loaded = tdconv.load_d2_pickle(str(path))
    assert set(loaded) == set(sd)
    want = jdconv.convert_densepose(jdconv.load_d2_pickle(str(path)), cfg_j,
                                    strict=True)
    got = tdconv.convert_densepose(loaded, trcnn.DensePoseConfig(**DP_CFG),
                                   strict=True)
    _same_tree(got, want)
    _same_tree(got["fpn"], tree["fpn"])
    _same_tree(got["box_head"], tree["box_head"])
    _same_tree(got["dp_head"], tree["dp_head"])
    model = tvis.DensePose.from_pickle(
        str(path), trcnn.DensePoseConfig(**DP_CFG), device="cpu").model
    np.testing.assert_array_equal(model.box_head.fc1.kernel.numpy(),
                                  tree["box_head"]["fc1"]["kernel"])
    np.testing.assert_array_equal(model.backbone.stem.bn.scale.numpy(),
                                  got["backbone"]["stem"]["bn"]["scale"])
