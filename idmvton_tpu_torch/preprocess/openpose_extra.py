"""OpenPose face and hand estimators (the annotator's remaining capability).

Counterpart of ``idmvton_tpu/preprocess/openpose_extra.py`` (the
reference's preprocess/openpose/annotator/openpose/face.py, hand.py and
util.py):

- FaceNet (face.py:12): a VGG trunk to conv5_3_CPM and 6 cascaded
  71-channel heatmap stages, stride 8. ``Face`` (:309): 384x384 input,
  x / 256 - 0.5, the last stage's heatmaps upsampled bilinear with
  align_corners=True; peaks (:355) by per-channel argmax over the > 0.05
  region, no smoothing.
- handpose_model (model.py:143): the same trunk, 6 cascaded 22-channel
  stages. ``Hand`` (hand.py:15): multi-scale square inference (0.5 / 1 /
  1.5 / 2 x 368), GaussianBlur 0.8, 128x128 averaged heatmaps, per part
  gaussian(3) + largest 8-connected component + argmax decode.
- crop-box proposals from body results (util.py:155 handDetect, :221
  faceDetect) and the drawing helpers.

The CNNs run NHWC on their device; the trunk's 3x3 convs with at least
128 channels (conv2_2 to conv5_3_CPM) take the conv kernels on the card
through ``layers.conv2d`` (fp32 x on bf16 weight copies, as OpenPose's
body net), as JAX sends them to its Pallas conv; the 7x7 Mconv stage convs
and the 1x1 convs are plain ``F.conv2d``, as JAX computes them outside
Pallas. Face's align-corners upsampling runs on the device (SCHP's
``_resize_bilinear``). The crop, resize and decode logic is host numpy /
OpenCV / scipy, as in JAX.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from idmvton_tpu_torch.models.layers import Conv, conv2d

_TRUNK = [  # shared VGG trunk (face.py:19-63 / model.py:152-169): stride 8
    ("conv1_1", 3, 64, 3), ("conv1_2", 64, 64, 3),
    ("conv2_1", 64, 128, 3), ("conv2_2", 128, 128, 3),
    ("conv3_1", 128, 256, 3), ("conv3_2", 256, 256, 3),
    ("conv3_3", 256, 256, 3), ("conv3_4", 256, 256, 3),
    ("conv4_1", 256, 512, 3), ("conv4_2", 512, 512, 3),
    ("conv4_3", 512, 512, 3), ("conv4_4", 512, 512, 3),
    ("conv5_1", 512, 512, 3), ("conv5_2", 512, 512, 3),
    ("conv5_3_CPM", 512, 128, 3),
]
_POOL_AFTER = {"conv1_2", "conv2_2", "conv3_4"}


def _refine_stage(n: int, out_ch: int):
    return [(f"Mconv1_stage{n}", 128 + out_ch, 128, 7)] + [
        (f"Mconv{i}_stage{n}", 128, 128, 7) for i in (2, 3, 4, 5)
    ] + [(f"Mconv6_stage{n}", 128, 128, 1),
         (f"Mconv7_stage{n}", 128, out_ch, 1)]


def _layers(out_ch: int):
    layers = {"trunk": _TRUNK,
              "stage1": [("conv6_1_CPM", 128, 512, 1),
                         ("conv6_2_CPM", 512, out_ch, 1)]}
    for n in range(2, 7):
        layers[f"stage{n}"] = _refine_stage(n, out_ch)
    return layers


N_FACE, N_HAND = 71, 22  # 70 landmarks + bg / 21 keypoints + bg


class CascadeNet(nn.Module):
    """The trunk and the 6 stages (``trunk``, ``stage1`` .. ``stage6``,
    each holding its convs by their reference names: JAX's tree)."""

    def __init__(self, out_ch: int, *, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.out_ch = out_ch
        for block, layers in _layers(out_ch).items():
            setattr(self, block, nn.ModuleDict(
                {name: Conv(i, o, k, dtype=dtype, device=device)
                 for name, i, o, k in layers}))

    def _run_block(self, block: str, x, *, final_no_relu: bool, impl):
        convs = getattr(self, block)
        names = list(convs.keys())
        for idx, name in enumerate(names):
            x = conv2d(convs[name], x, impl=impl)
            if not (final_no_relu and idx == len(names) - 1):
                x = F.relu(x)
            if name in _POOL_AFTER:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(
                    0, 2, 3, 1).contiguous()
        return x

    def forward(self, x, *, impl=None):
        """x (B, H, W, 3) in [-0.5, 0.5]. Returns the stage-6 heatmaps
        (B, H/8, W/8, out_ch), the only stage the wrappers read."""
        feat = self._run_block("trunk", x, final_no_relu=False, impl=impl)
        h = self._run_block("stage1", feat, final_no_relu=True, impl=impl)
        for n in range(2, 7):
            inp = torch.cat([h, feat], dim=-1)  # torch cat([h, feature])
            h = self._run_block(f"stage{n}", inp, final_no_relu=True,
                                impl=impl)
        return h


def _init(out_ch: int, seed: int, dtype, device) -> CascadeNet:
    from idmvton_tpu_torch.models.layers import reset_parameters_
    net = CascadeNet(out_ch, dtype=dtype, device=device)
    reset_parameters_(net, torch.Generator(device=device).manual_seed(seed))
    return net


def init_facenet(seed: int = 0, *, dtype=torch.float32,
                 device="cuda") -> CascadeNet:
    """FaceNet with seeded random weights (fan-in normal, zero biases)."""
    return _init(N_FACE, seed, dtype, device)


def init_handpose(seed: int = 0, *, dtype=torch.float32,
                  device="cuda") -> CascadeNet:
    """handpose_model with seeded random weights."""
    return _init(N_HAND, seed, dtype, device)


def convert_facenet(sd, dtype=torch.float32, *, strict: bool = False
                    ) -> dict:
    """FaceNet ships flat keys ('conv1_1.weight', 'Mconv1_stage2.weight',
    face.py:12-139) -> the net's tree (CPU tensors, JAX's key names)."""
    return _convert(sd, N_FACE, lambda block, name: name, dtype, strict)


def convert_handpose(sd, dtype=torch.float32, *, strict: bool = False
                     ) -> dict:
    """handpose_model keys are block-prefixed ('model1_0.conv1_1.weight',
    model.py:196-202: model1_0 = trunk, model1_1 = stage1, model2..6)."""
    def keyfn(block, name):
        prefix = {"trunk": "model1_0", "stage1": "model1_1"}.get(
            block, "model" + block[len("stage"):])
        return f"{prefix}.{name}"
    return _convert(sd, N_HAND, keyfn, dtype, strict)


def _convert(sd, out_ch, keyfn, dtype, strict):
    from idmvton_tpu_torch.preprocess.densepose.convert import conv_leaf
    params: Dict[str, dict] = {}
    used = set()
    for block, layers in _layers(out_ch).items():
        params[block] = {}
        for name, _, _, _ in layers:
            k = keyfn(block, name)
            used.update((k + ".weight", k + ".bias"))
            params[block][name] = conv_leaf(sd[k + ".weight"],
                                            sd[k + ".bias"], dtype)
    if strict:
        from idmvton_tpu_torch.weights.converter import check_consumed
        check_consumed(sd, used)
    return params


def _load(out_ch: int, convert, path: str, device) -> CascadeNet:
    from idmvton_tpu_torch.weights.converter import load_state_dict
    from idmvton_tpu_torch.weights.from_jax import load_module_params
    net = CascadeNet(out_ch, device=device)
    load_module_params(net, convert(load_state_dict(path)))
    return net


# ---------------------------------------------------------------------------
# host-side resize helpers (reference util.py:10-35 smart_resize semantics)
# ---------------------------------------------------------------------------


def _smart_resize(x: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """cv2 resize with the reference's kernel rule: INTER_AREA when
    shrinking, LANCZOS4 when growing (util.py:10-21); >4-channel arrays go
    per channel like the reference."""
    import cv2
    ht, wt = hw
    ho, wo = x.shape[:2]
    co = 1 if x.ndim == 2 else x.shape[2]
    if co in (1, 3):
        k = float(ht + wt) / float(ho + wo)
        interp = cv2.INTER_AREA if k < 1 else cv2.INTER_LANCZOS4
        return cv2.resize(x, (int(wt), int(ht)), interpolation=interp)
    return np.stack([_smart_resize(x[:, :, i], hw) for i in range(co)],
                    axis=2)


def _ac_upsample(hm: torch.Tensor, hw: Tuple[int, int]) -> np.ndarray:
    """(1, h, w, C) on its device -> (H, W, C) numpy: bilinear with
    align_corners=True (F.interpolate in face.py:344-347)."""
    from idmvton_tpu_torch.preprocess.schp import _resize_bilinear
    return _resize_bilinear(hm, hw)[0].cpu().numpy()


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


class Face:
    """face crop (H, W, 3) uint8 -> 71-channel heatmaps at crop resolution
    (face.py:309-352). ``peaks`` reproduces compute_peaks_from_heatmaps
    (:355-368). ``net`` defaults to the seeded random FaceNet on
    ``device``; ``impl`` is the conv sites' impl (None: follow the
    device)."""

    def __init__(self, net: Optional[CascadeNet] = None, *,
                 input_size: int = 384, threshold: float = 0.05,
                 device="cuda", impl=None):
        self.net = net if net is not None else init_facenet(0,
                                                            device=device)
        self.input_size = input_size
        self.threshold = threshold
        self.impl = impl

    @staticmethod
    def from_torch(path: str, *, device="cuda") -> "Face":
        return Face(_load(N_FACE, convert_facenet, path, device))

    def _cnn(self, x: np.ndarray) -> torch.Tensor:
        """The net on one (1, H, W, 3) input, its heatmaps on the device."""
        dev = next(self.net.parameters()).device
        with torch.no_grad():
            return self.net(torch.from_numpy(x).to(dev), impl=self.impl)

    def heatmaps(self, face_img: np.ndarray) -> np.ndarray:
        h, w = face_img.shape[:2]
        s = self.input_size
        x = _smart_resize(face_img, (s, s)).astype(np.float32) / 256.0 - 0.5
        with torch.no_grad():
            return _ac_upsample(self._cnn(x[None]), (h, w))   # (H, W, 71)

    def peaks(self, heatmaps: np.ndarray) -> np.ndarray:
        """Per-channel argmax over the > threshold region; channels with no
        pixel above threshold are skipped (face.py:355-368)."""
        out = []
        for part in range(heatmaps.shape[-1]):
            m = heatmaps[:, :, part]
            binary = m > self.threshold
            if not binary.any():
                continue
            ys, xs = np.where(binary)
            mi = np.argmax(m[ys, xs])
            out.append([int(xs[mi]), int(ys[mi])])
        return np.asarray(out)

    def __call__(self, face_img: np.ndarray) -> np.ndarray:
        return self.peaks(self.heatmaps(face_img))


class Hand:
    """hand crop (H, W, 3) uint8 BGR -> 21 keypoints [x, y] in crop coords
    (hand.py:25-87): multi-scale square inference, 128x128 averaged
    heatmaps, gaussian(3) + largest 8-connected component + argmax.
    ``net`` defaults to the seeded random handpose net on ``device``."""

    def __init__(self, net: Optional[CascadeNet] = None, *,
                 boxsize: int = 368, stride: int = 8,
                 scales: Sequence[float] = (0.5, 1.0, 1.5, 2.0),
                 map_size: int = 128, threshold: float = 0.05,
                 device="cuda", impl=None):
        self.net = net if net is not None else init_handpose(0,
                                                             device=device)
        self.boxsize = boxsize
        self.stride = stride
        self.scales = tuple(scales)
        self.map_size = map_size
        self.threshold = threshold
        self.impl = impl

    @staticmethod
    def from_torch(path: str, *, device="cuda") -> "Hand":
        return Hand(_load(N_HAND, convert_handpose, path, device))

    def _cnn(self, im: np.ndarray) -> np.ndarray:
        """The net on one padded (H, W, 3) image: heatmaps (H/8, W/8, 22)."""
        dev = next(self.net.parameters()).device
        x = torch.from_numpy(im.astype(np.float32)[None] / 256.0 - 0.5)
        with torch.no_grad():
            return self.net(x.to(dev), impl=self.impl)[0].cpu().numpy()

    def heatmaps(self, image_bgr: np.ndarray) -> np.ndarray:
        import cv2
        ws = self.map_size
        avg = np.zeros((ws, ws, N_HAND), np.float32)
        blurred = cv2.GaussianBlur(image_bgr, (0, 0), 0.8)
        for scale in self.scales:
            side = int(scale * self.boxsize)
            im = _smart_resize(blurred, (side, side))
            ph = (self.stride - side % self.stride) % self.stride
            # padRightDownCorner pads bottom/right with 128 (util.py:38-56)
            im = np.pad(im, ((0, ph), (0, ph), (0, 0)), mode="constant",
                        constant_values=128)
            hm = self._cnn(im)
            hm = _smart_resize(hm, (hm.shape[0] * self.stride,
                                    hm.shape[1] * self.stride))
            hm = hm[:im.shape[0] - ph or None, :im.shape[1] - ph or None]
            avg += _smart_resize(hm, (ws, ws)) / len(self.scales)
        return avg

    def peaks(self, heatmap_avg: np.ndarray,
              orig_hw: Tuple[int, int]) -> np.ndarray:
        from scipy.ndimage import gaussian_filter, label
        hr, wr = orig_hw
        ws = self.map_size
        out = []
        for part in range(N_HAND - 1):
            map_ori = heatmap_avg[:, :, part].copy()
            smooth = gaussian_filter(map_ori, sigma=3)
            binary = smooth > self.threshold
            if not binary.any():
                out.append([0, 0])
                continue
            # largest component by summed original intensity, 8-connected
            # (skimage label connectivity=2 in the reference)
            lab, n = label(binary, structure=np.ones((3, 3), np.int32))
            sums = [map_ori[lab == i].sum() for i in range(1, n + 1)]
            keep = int(np.argmax(sums)) + 1
            map_ori[lab != keep] = 0
            # util.npmax: row of the global max, then that row's argmax
            y = int(np.argmax(map_ori.max(axis=1)))
            x = int(np.argmax(map_ori[y]))
            out.append([int(x * wr / ws), int(y * hr / ws)])
        return np.asarray(out)

    def __call__(self, image_bgr: np.ndarray) -> np.ndarray:
        return self.peaks(self.heatmaps(image_bgr), image_bgr.shape[:2])


# ---------------------------------------------------------------------------
# crop-box proposals from body results (util.py:155-290)
# ---------------------------------------------------------------------------


def detect_hands(candidate: np.ndarray, subset: np.ndarray,
                 img_hw: Tuple[int, int]) -> List[list]:
    """[[x, y, w, is_left], ...] square crops from wrist / elbow / shoulder
    geometry (util.py:155-218)."""
    ratio = 0.33
    ih, iw = img_hw
    out = []
    for person in subset.astype(int):
        sides = []
        if (person[[5, 6, 7]] >= 0).all():
            sides.append((person[5], person[6], person[7], True))
        if (person[[2, 3, 4]] >= 0).all():
            sides.append((person[2], person[3], person[4], False))
        for s_i, e_i, w_i, is_left in sides:
            (x1, y1), (x2, y2), (x3, y3) = (candidate[s_i][:2],
                                            candidate[e_i][:2],
                                            candidate[w_i][:2])
            x = x3 + ratio * (x3 - x2)
            y = y3 + ratio * (y3 - y2)
            d_we = math.hypot(x3 - x2, y3 - y2)
            d_es = math.hypot(x2 - x1, y2 - y1)
            width = 1.5 * max(d_we, 0.9 * d_es)
            x, y = max(x - width / 2, 0), max(y - width / 2, 0)
            width = min(width if x + width <= iw else iw - x,
                        width if y + width <= ih else ih - y)
            if width >= 20:
                out.append([int(x), int(y), int(width), is_left])
    return out


def detect_faces(candidate: np.ndarray, subset: np.ndarray,
                 img_hw: Tuple[int, int]) -> List[list]:
    """[[x, y, w], ...] square crops from nose / eye / ear geometry
    (util.py:221-289)."""
    ih, iw = img_hw
    out = []
    for person in subset.astype(int):
        if person[0] < 0:
            continue
        x0, y0 = candidate[person[0]][:2]
        width = 0.0
        for idx, factor in ((14, 3.0), (15, 3.0), (16, 1.5), (17, 1.5)):
            if person[idx] >= 0:
                x1, y1 = candidate[person[idx]][:2]
                width = max(width, max(abs(x0 - x1), abs(y0 - y1)) * factor)
        if width == 0.0:
            continue
        x, y = max(x0 - width, 0), max(y0 - width, 0)
        w2 = min(width * 2 if x + width <= iw else iw - x,
                 width * 2 if y + width <= ih else ih - y)
        if w2 >= 20:
            out.append([int(x), int(y), int(w2)])
    return out


# ---------------------------------------------------------------------------
# drawing (util.py draw_handpose / draw_facepose semantics)
# ---------------------------------------------------------------------------

_HAND_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 4), (0, 5), (5, 6), (6, 7), (7, 8), (0, 9),
    (9, 10), (10, 11), (11, 12), (0, 13), (13, 14), (14, 15), (15, 16),
    (0, 17), (17, 18), (18, 19), (19, 20),
]


def draw_handpose(canvas: np.ndarray, peaks: np.ndarray) -> np.ndarray:
    """Skeleton edges HSV-colored by edge index + numbered joints."""
    import cv2
    out = canvas.copy()
    for ie, (a, b) in enumerate(_HAND_EDGES):
        if (peaks[a] == 0).all() or (peaks[b] == 0).all():
            continue
        hue = int(ie / len(_HAND_EDGES) * 179)
        color = cv2.cvtColor(
            np.asarray([[[hue, 255, 255]]], np.uint8),
            cv2.COLOR_HSV2BGR)[0, 0]
        cv2.line(out, tuple(peaks[a]), tuple(peaks[b]),
                 tuple(int(c) for c in color), 2)
    for p in peaks:
        if not (p == 0).all():
            cv2.circle(out, tuple(p), 4, (0, 0, 255), -1)
    return out


def draw_facepose(canvas: np.ndarray, peaks: np.ndarray) -> np.ndarray:
    import cv2
    out = canvas.copy()
    for p in peaks:
        cv2.circle(out, tuple(int(v) for v in p), 3, (255, 255, 255), -1)
    return out
