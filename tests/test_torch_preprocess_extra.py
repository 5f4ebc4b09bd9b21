"""The rest of the port's preprocessing against the JAX package's, on the CPU:
the OpenPose face and hand estimators (``preprocess/openpose_extra.py``),
``preprocess/inpaint_crop.py``, ``ops/rotated_boxes.py`` and
``ops/deform_conv.py``.

FaceNet and handpose run on shared random parameters (the port's seeded
init with random biases, exported to JAX's tree) at reduced inputs; JAX
runs op by op (``jax.disable_jit``). The wrappers run end to end on the
same stub heatmaps on both sides (JAX's own stub, so the resize, pad,
upsample and decode chains are compared), then on the random nets. These
stand in, for the port, for the reference-parity tests of
``test_openpose_extra.py``, which need the reference tree.

Tolerances: fp32 nets and maps within 1e-4 of their largest magnitude
(other summation orders); rotated IoU and deformable conv within 1e-5;
peaks, crops, keep masks, converted weights and drawn images equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idmvton_tpu.ops import deform_conv as jdc
from idmvton_tpu.ops import rotated_boxes as jrb
from idmvton_tpu.preprocess import inpaint_crop as jic
from idmvton_tpu.preprocess import openpose_extra as jox
from idmvton_tpu_torch.ops import deform_conv as tdc
from idmvton_tpu_torch.ops import rotated_boxes as trb
from idmvton_tpu_torch.preprocess import inpaint_crop as tic
from idmvton_tpu_torch.preprocess import openpose_extra as tox
from idmvton_tpu_torch.weights.from_jax import load_module_params
from test_openpose_extra import _avgpool_stub_np

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-6)
    assert err <= tol, err


def module_tree(module) -> dict:
    """A module's parameters as JAX's nested tree of numpy arrays (dicts,
    with lists where the names count)."""
    tree = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.detach().numpy().copy()

    def lists(t):
        if not isinstance(t, dict):
            return t
        if t and all(k.isdigit() for k in t):
            return [lists(t[str(i)]) for i in range(len(t))]
        return {k: lists(v) for k, v in t.items()}

    return lists(tree)


def _random_biases(tree, seed):
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, list):
            return [walk(v) for v in t]
        return {k: (walk(v) if isinstance(v, (dict, list)) else
                    (rng.standard_normal(v.shape) * 0.1).astype(v.dtype)
                    if k == "bias" else v) for k, v in t.items()}

    return walk(tree)


# ---------------------------------------------------------------------------
# FaceNet / handpose
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nets():
    """{"face" | "hand": (port net, JAX tree)} on shared random
    parameters."""
    out = {}
    for name, init in (("face", tox.init_facenet),
                       ("hand", tox.init_handpose)):
        net = init(3, device="cpu")
        tree = _random_biases(module_tree(net), 4)
        load_module_params(net, tree)
        out[name] = (net, jax.tree.map(jnp.asarray, tree))
    return out


@pytest.mark.parametrize("name,apply,hw", [
    ("face", jox.facenet_apply, (48, 40)),
    ("hand", jox.handpose_apply, (40, 56)),
])
def test_cascade_nets_match_jax(nets, name, apply, hw):
    net, tree = nets[name]
    x = (np.random.default_rng(5).uniform(0, 1, (1, *hw, 3)) - 0.5
         ).astype(np.float32)
    with jax.disable_jit():
        want = apply(tree, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.shape == (1, hw[0] // 8, hw[1] // 8, net.out_ch)
    _close(got, want)


def test_face_on_stub_heatmaps_matches_jax(nets, monkeypatch):
    """Face.heatmaps / peaks on the same stub CNN: the resize to 384, the
    align-corners upsample and the peaks."""
    img = np.random.default_rng(6).integers(0, 255, (90, 70, 3), np.uint8)
    jface = jox.Face(nets["face"][1])
    monkeypatch.setattr(jface, "_apply", lambda p, x: jnp.asarray(
        _avgpool_stub_np(np.asarray(x)[0], jox.N_FACE)[None]))
    tface = tox.Face(nets["face"][0])
    monkeypatch.setattr(tface, "_cnn", lambda x: torch.from_numpy(
        _avgpool_stub_np(x[0], tox.N_FACE)[None]))
    want = jface.heatmaps(img)
    got = tface.heatmaps(img)
    _close(got, want)
    np.testing.assert_array_equal(tface.peaks(want), jface.peaks(want))
    np.testing.assert_array_equal(tface(img), jface(img))


def test_hand_on_stub_heatmaps_matches_jax(nets, monkeypatch):
    """JAX's own stub test (the four scales, blur, pad, stride-8 upsample,
    crop, average, gaussian + component + npmax decode) on both."""
    img = np.random.default_rng(4).integers(0, 255, (80, 60, 3), np.uint8)
    stub = lambda im: _avgpool_stub_np(im.astype(np.float32) / 256.0 - 0.5,
                                       jox.N_HAND)
    jhand = jox.Hand(nets["hand"][1])
    thand = tox.Hand(nets["hand"][0])
    monkeypatch.setattr(jhand, "_cnn", stub)
    monkeypatch.setattr(thand, "_cnn", stub)
    np.testing.assert_array_equal(thand.heatmaps(img), jhand.heatmaps(img))
    np.testing.assert_array_equal(thand(img), jhand(img))


def test_wrappers_on_the_random_nets_match_jax(nets):
    """Face at 64 and Hand at two scales of 48 with the nets themselves:
    the heatmaps within TOL, the peaks equal."""
    jface = jox.Face(nets["face"][1], input_size=64)
    tface = tox.Face(nets["face"][0], input_size=64)
    img = np.random.default_rng(7).integers(0, 255, (56, 48, 3), np.uint8)
    with jax.disable_jit():
        want = jface.heatmaps(img)
    got = tface.heatmaps(img)
    _close(got, want)
    np.testing.assert_array_equal(tface.peaks(got), jface.peaks(want))

    kw = dict(boxsize=48, scales=(0.5, 1.0), map_size=32)
    jhand = jox.Hand(nets["hand"][1], **kw)
    thand = tox.Hand(nets["hand"][0], **kw)
    img = np.random.default_rng(8).integers(0, 255, (40, 32, 3), np.uint8)
    with jax.disable_jit():
        want = jhand.heatmaps(img)
    got = thand.heatmaps(img)
    _close(got, want)
    np.testing.assert_array_equal(thand.peaks(got, img.shape[:2]),
                                  jhand.peaks(want, img.shape[:2]))


def _torch_sd(tree, keyfn):
    sd = {}
    for block, layers in tree.items():
        for name, p in layers.items():
            k = keyfn(block, name)
            sd[k + ".weight"] = np.ascontiguousarray(
                np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
            sd[k + ".bias"] = np.asarray(p["bias"])
    return sd


@pytest.mark.parametrize("name", ["face", "hand"])
def test_converters_match_jax(nets, name):
    """convert_facenet / convert_handpose on a torch-layout state dict:
    the same tree as JAX's, bit for bit, filling the net; strict refuses
    an unconsumed key."""
    tree = nets[name][1]
    if name == "face":
        keyfn = lambda block, layer: layer
        jconv, tconv = jox.convert_facenet, tox.convert_facenet
    else:
        keyfn = lambda block, layer: {"trunk": "model1_0",
                                      "stage1": "model1_1"}.get(
            block, "model" + block[len("stage"):]) + "." + layer
        jconv, tconv = jox.convert_handpose, tox.convert_handpose
    sd = _torch_sd(tree, keyfn)
    want, got = jconv(sd), tconv(sd)
    for block in want:
        for layer in want[block]:
            for leaf in ("kernel", "bias"):
                np.testing.assert_array_equal(
                    got[block][layer][leaf].numpy(),
                    np.asarray(want[block][layer][leaf]))
    load_module_params(tox.CascadeNet(nets[name][0].out_ch, device="cpu"),
                       got)
    with pytest.raises(ValueError):
        tconv(dict(sd, stray=np.zeros(1)), strict=True)


def test_crop_proposals_and_drawing_match_jax():
    rng = np.random.default_rng(5)
    candidate = np.concatenate(
        [rng.uniform(10, 300, (36, 2)), rng.uniform(0, 1, (36, 2))], axis=1)
    subset = np.full((3, 20), -1.0)
    subset[0, :18] = np.arange(18)
    subset[1, [0, 2, 3, 4, 14, 16]] = np.arange(18, 24)
    subset[2, [5, 6, 7, 15]] = np.arange(24, 28)
    for hw in ((320, 320), (200, 150)):
        assert tox.detect_hands(candidate, subset, hw) == \
            jox.detect_hands(candidate, subset, hw)
        assert tox.detect_faces(candidate, subset, hw) == \
            jox.detect_faces(candidate, subset, hw)
    canvas = rng.integers(0, 255, (64, 64, 3), np.uint8)
    peaks = rng.integers(1, 63, (21, 2))
    peaks[[3, 9]] = 0
    np.testing.assert_array_equal(tox.draw_handpose(canvas, peaks),
                                  jox.draw_handpose(canvas, peaks))
    np.testing.assert_array_equal(tox.draw_facepose(canvas, peaks),
                                  jox.draw_facepose(canvas, peaks))


# ---------------------------------------------------------------------------
# inpaint_crop
# ---------------------------------------------------------------------------


def test_inpaint_crop_matches_jax():
    rng = np.random.default_rng(9)
    h, w = 100, 80
    masks = []
    for box in ((40, 60, 30, 50), (0, 10, 0, 40), (5, 95, 70, 80),
                (90, 100, 2, 6)):
        m = np.zeros((h, w), np.uint8)
        m[box[0]:box[1], box[2]:box[3]] = 255
        masks.append(m)
    masks += [np.zeros((h, w), np.uint8),
              (rng.uniform(0, 1, (h, w)) > 0.995).astype(np.uint8)]
    person = rng.integers(0, 255, (h, w, 3), np.uint8)
    for m in masks:
        for size, pad in (((64, 64), 0), ((128, 64), 5), ((64, 128), 12),
                          ((48, 64), 3)):
            region = tic.get_crop_region(m, *size, pad=pad)
            assert region == jic.get_crop_region(m, *size, pad=pad)
            out_hw = (size[1], size[0])
            np.testing.assert_array_equal(
                tic.crop_resize(person, region, out_hw),
                jic.crop_resize(person, region, out_hw))
            np.testing.assert_array_equal(
                tic.crop_resize(m[..., None], region, out_hw, nearest=True),
                jic.crop_resize(m[..., None], region, out_hw, nearest=True))
            gen = rng.integers(0, 255, (*out_hw, 3), np.uint8)
            for mk, orig in ((m, person), (m[..., None] / 255.0,
                                           person.astype(np.float32))):
                np.testing.assert_array_equal(
                    tic.apply_overlay(mk, orig, gen, region),
                    jic.apply_overlay(mk, orig, gen, region))
    np.testing.assert_array_equal(
        tic.apply_overlay(masks[0], person, person[::-1]),
        jic.apply_overlay(masks[0], person, person[::-1]))


# ---------------------------------------------------------------------------
# rotated boxes, deformable conv
# ---------------------------------------------------------------------------


def _rboxes(n, seed, span=20.0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0, span, (n, 2)),
                           rng.uniform(1, span / 3, (n, 2)),
                           rng.uniform(-90, 90, (n, 1))], 1).astype(
        np.float32)


def test_rotated_iou_and_nms_match_jax():
    a, b = _rboxes(14, 0), _rboxes(9, 1)
    b[0] = a[0]                            # identical pair
    b[1] = [100.0, 100.0, 2.0, 2.0, 10.0]  # disjoint
    b[2] = a[2] + np.asarray([0, 0, 0, 0, 45], np.float32)
    _close(trb.box_corners(torch.from_numpy(a)),
           jrb.box_corners(jnp.asarray(a)), 1e-5)
    want = np.asarray(jrb.box_iou_rotated(jnp.asarray(a), jnp.asarray(b)))
    got = trb.box_iou_rotated(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert abs(float(got[0, 0]) - 1.0) < 1e-5 and float(got[1, 1]) == 0.0
    for seed, thr in ((2, 0.5), (3, 0.2)):
        boxes = _rboxes(24, seed, 12.0)
        scores = (np.round(np.random.default_rng(seed).uniform(0, 1, 24) * 6)
                  / 6).astype(np.float32)     # forced ties
        np.testing.assert_array_equal(
            trb.nms_rotated_mask(torch.from_numpy(boxes),
                                 torch.from_numpy(scores),
                                 iou_threshold=thr).numpy(),
            np.asarray(jrb.nms_rotated_mask(jnp.asarray(boxes),
                                            jnp.asarray(scores),
                                            iou_threshold=thr)))


@pytest.mark.parametrize("stride,modulated", [(1, False), (1, True),
                                              (2, True)])
def test_deform_conv_matches_jax(stride, modulated):
    rng = np.random.default_rng(10 + stride)
    x = rng.standard_normal((2, 9, 11, 4)).astype(np.float32)
    ho, wo = -(-9 // stride), -(-11 // stride)
    # offsets reaching past the border (taps there read zero)
    off = (rng.standard_normal((2, ho, wo, 18)) * 2.5).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, 4, 5)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    mask = (rng.uniform(0, 1, (2, ho, wo, 9)).astype(np.float32)
            if modulated else None)
    want = jdc.deform_conv2d(jnp.asarray(x), jnp.asarray(off),
                             jnp.asarray(kernel), stride=stride,
                             mask=None if mask is None else jnp.asarray(mask),
                             bias=jnp.asarray(bias))
    got = tdc.deform_conv2d(torch.from_numpy(x), torch.from_numpy(off),
                            torch.from_numpy(kernel), stride=stride,
                            mask=None if mask is None
                            else torch.from_numpy(mask),
                            bias=torch.from_numpy(bias))
    _close(got, want, 1e-5)
