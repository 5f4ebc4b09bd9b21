"""The port's host runtime (``runtime/native.py``, ``csrc/native.cc``) and
the detection evaluation harness against the JAX package's, on the CPU.

Both runtimes run the same C++ bodies, so every output is equal: the
ROIAlign oracle and NMS bit for bit in fp32, the COCO evaluators bit for
bit in fp64. The port's library is its own (a ctypes library under
``idmvton_tpu_torch/_build/``, never JAX's extension module). The
evaluator is held to JAX's on the same detections, and the port's
``DensePose.detect`` drives ``inference_on_dataset`` end to end.
"""

import numpy as np
import jax.numpy as jnp
import torch

from idmvton_tpu.ops.roi_align import roi_align as j_roi_align
from idmvton_tpu.preprocess.densepose import evaluate as jeval
from idmvton_tpu.runtime import native as jnat
from idmvton_tpu_torch.ops.roi_align import roi_align as t_roi_align
from idmvton_tpu_torch.preprocess.densepose import evaluate as teval
from idmvton_tpu_torch.preprocess.densepose import rcnn as trcnn
from idmvton_tpu_torch.preprocess.densepose import visualize as tvis
from idmvton_tpu_torch.runtime import native as tnat
from test_native import _synthetic_coco_fixture


def _boxes(n, seed, span=40.0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, span, (n, 2))
    s = rng.uniform(2, span / 3, (n, 2))
    return np.concatenate([c - s / 2, c + s / 2], 1).astype(np.float32)


def test_library_is_the_ports_own():
    """Built from the port's source into the port's build directory, named
    by the source's hash; it is a plain library, not JAX's module."""
    path = tnat.build()
    assert path.parent == tnat.BUILD_DIR
    assert path.parent.parent.name == "idmvton_tpu_torch"
    assert path.name.startswith("libidmvton_native_")
    assert tnat.SOURCE.read_bytes().count(b"Python.h") == 0
    assert tnat.get_native() is tnat.get_native()


def test_roi_align_cpu_matches_jax_and_the_port():
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((2, 12, 16, 5)).astype(np.float32)
    boxes = np.asarray([[1.0, 2.0, 12.0, 10.0], [0.0, 0.0, 16.0, 12.0],
                        [-3.0, 5.5, 9.25, 30.0], [4.0, 4.0, 4.0, 4.0]],
                       np.float32)
    idx = np.asarray([0, 1, -1, 1], np.int32)
    for out, ratio, scale in ((5, 2, 1.0), (7, 3, 0.5)):
        kw = dict(output_size=out, sampling_ratio=ratio, spatial_scale=scale)
        got = tnat.roi_align_cpu(feat, boxes, idx, **kw)
        np.testing.assert_array_equal(got, jnat.roi_align_cpu(
            feat, boxes, idx, **kw))
        # the port's gather formulation: same semantics, other order
        ref = t_roi_align(torch.from_numpy(feat), torch.from_numpy(boxes),
                          torch.from_numpy(idx), **kw).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, np.asarray(j_roi_align(
            jnp.asarray(feat), jnp.asarray(boxes), jnp.asarray(idx), **kw)),
            rtol=0, atol=1e-5)


def test_nms_cpu_and_coco_ap_match_jax():
    for seed, thr in ((1, 0.5), (2, 0.3)):
        boxes = _boxes(80, seed)
        scores = np.round(np.random.default_rng(seed).uniform(0, 1, 80)
                          * 8).astype(np.float32) / 8   # forced ties
        np.testing.assert_array_equal(tnat.nms_cpu(boxes, scores, thr),
                                      jnat.nms_cpu(boxes, scores, thr))
    gt = np.concatenate([np.repeat(np.arange(3), 4)[:, None],
                         _boxes(12, 3, 200.0)], 1).astype(np.float32)
    det = np.concatenate([np.repeat(np.arange(3), 6)[:, None],
                          np.random.default_rng(4).uniform(0, 1, (18, 1)),
                          _boxes(18, 5, 200.0)], 1).astype(np.float32)
    det[:8, 2:] = gt[:8, 1:] + 1.5          # some close matches
    for d, g in ((det, gt), (det[:0], gt), (det, gt[:0])):
        assert tnat.coco_ap(d, g) == jnat.coco_ap(d, g)
    assert 0.0 < tnat.coco_ap(det, gt) < 1.0


def test_coco_evaluate_matches_jax():
    dets, gts = _synthetic_coco_fixture()
    for kw in ({}, dict(max_dets=np.array([1, 5, 20])),
               dict(iou_thrs=np.array([0.5, 0.75]),
                    area_rngs=np.array([[0, 1e10]]))):
        got = tnat.coco_evaluate(dets, gts, **kw)
        want = jnat.coco_evaluate(dets, gts, **kw)
        for k in ("precision", "recall", "scores", "stats"):
            np.testing.assert_array_equal(got[k], want[k])
    empty = tnat.coco_evaluate(np.zeros((0, 7)), gts)
    np.testing.assert_array_equal(
        empty["stats"], jnat.coco_evaluate(np.zeros((0, 7)), gts)["stats"])


def test_detection_evaluator_matches_jax():
    """process / evaluate over padded fixed-count predictions, valid masks
    and crowd ground truth: the same accumulated rows and 12 stats."""
    rng = np.random.default_rng(6)
    evs = (teval.DetectionEvaluator(), jeval.DetectionEvaluator())
    for image_id in range(3):
        gt = _boxes(3, 10 + image_id, 300.0)
        boxes = np.concatenate([gt + rng.uniform(-4, 4, gt.shape),
                                _boxes(5, 20 + image_id, 300.0)])
        scores = rng.uniform(0, 1, len(boxes)).astype(np.float32)
        valid = rng.uniform(0, 1, len(boxes)) > 0.2
        crowd = np.asarray([0, 0, image_id == 1], np.float32)
        for ev in evs:
            ev.process(image_id, boxes, scores, gt, valid=valid,
                       iscrowd=crowd)
    got, want = (ev.evaluate() for ev in evs)
    assert got["n_images"] == want["n_images"] == 3
    np.testing.assert_array_equal(got["stats"], want["stats"])
    np.testing.assert_array_equal(got["precision"], want["precision"])


def test_inference_on_dataset_with_the_ports_detector():
    """The port's ``DensePose.detect`` (a small random R-CNN on the CPU)
    over three images through ``inference_on_dataset``: 12 finite stats,
    equal to JAX's evaluator on the same detections."""
    cfg = trcnn.DensePoseConfig(rpn_pre_nms_topk=50, rpn_post_nms_topk=20,
                                num_detections=4, dp_chunk=2, dp_convs=1,
                                dp_dim=64)
    model = trcnn.init_densepose_rcnn(0, cfg, device="cpu")
    with torch.no_grad():   # the stem at mean-subtracted pixel scale
        model.backbone.stem.conv.kernel.div_(50.0)
    dp = tvis.DensePose(model, short_edge=64, max_size=96)
    rng = np.random.default_rng(7)
    data = [(i, rng.integers(0, 255, (96, 72, 3), np.uint8),
             np.asarray([[8.0, 10.0, 50.0, 80.0]], np.float32))
            for i in range(3)]
    calls = []

    def detect(img):
        calls.append(dp.detect(img))
        return calls[-1]

    got = teval.inference_on_dataset(detect, data)
    want = jeval.inference_on_dataset(lambda img: calls.pop(0), data)
    assert got["n_images"] == 3 and got["stats"].shape == (12,)
    assert np.isfinite(got["stats"]).all()
    np.testing.assert_array_equal(got["stats"], want["stats"])
