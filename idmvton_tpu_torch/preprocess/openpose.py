"""OpenPose body-pose estimation: the CMU 2-branch PAF / heatmap CNN and
the host-side multi-person decode.

Counterpart of ``idmvton_tpu/preprocess/openpose.py`` (the reference's
bodypose_model: a VGG-style trunk and 6 refinement stages, branch L1 = 38
part-affinity fields, branch L2 = 19 keypoint heatmaps; the decode:
multi-scale heatmap averaging, gaussian peak finding, PAF line-integral
bipartite matching; the wrapper: exactly 18 keypoints in 384x512 coords).

The CNN runs NHWC on its device; its 3x3 convs with at least 128 channels
(``conv2_2``, ``conv3_*``, ``conv4_*``, ``conv5_{1,2,3}_CPM_*``) take the
conv kernels on the card through ``layers.conv2d``, as JAX sends them to
its Pallas conv. The x8 bilinear upsampling of the maps runs there too.
The input resize (OpenCV cubic) and the resize back to the image (OpenCV
linear) are host OpenCV, as in JAX. The peaks are found on the net's
device (``find_peaks``: scipy's Gaussian in float64, the same rounding, so
JAX's peaks to the bit), and the PAF matching on the host scores a limb's
candidate pairs in one array pass (``_pair_scores``), where JAX loops over
them in Python; both keep JAX's bits.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from idmvton_tpu_torch.models.layers import Conv, conv2d
from idmvton_tpu_torch.utils.profiling import span

# (name, in, out, kernel) per block; pools follow conv1_2, conv2_2, conv3_4
_TRUNK = [
    ("conv1_1", 3, 64, 3), ("conv1_2", 64, 64, 3),
    ("conv2_1", 64, 128, 3), ("conv2_2", 128, 128, 3),
    ("conv3_1", 128, 256, 3), ("conv3_2", 256, 256, 3),
    ("conv3_3", 256, 256, 3), ("conv3_4", 256, 256, 3),
    ("conv4_1", 256, 512, 3), ("conv4_2", 512, 512, 3),
    ("conv4_3_CPM", 512, 256, 3), ("conv4_4_CPM", 256, 128, 3),
]
_POOL_AFTER = {"conv1_2", "conv2_2", "conv3_4"}
_N_PAF, _N_HEAT = 38, 19


def _stage1(branch: str, out_ch: int):
    return [(f"conv5_{i}_CPM_{branch}", 128, 128, 3) for i in (1, 2, 3)] + [
        (f"conv5_4_CPM_{branch}", 128, 512, 1),
        (f"conv5_5_CPM_{branch}", 512, out_ch, 1),
    ]


def _stageN(n: int, branch: str, out_ch: int):
    in_ch = 128 + _N_PAF + _N_HEAT
    return [(f"Mconv1_stage{n}_{branch}", in_ch, 128, 7)] + [
        (f"Mconv{i}_stage{n}_{branch}", 128, 128, 7) for i in (2, 3, 4, 5)
    ] + [
        (f"Mconv6_stage{n}_{branch}", 128, 128, 1),
        (f"Mconv7_stage{n}_{branch}", 128, out_ch, 1),
    ]


def _all_layers():
    layers = {"model0": _TRUNK}
    layers["model1_1"] = _stage1("L1", _N_PAF)
    layers["model1_2"] = _stage1("L2", _N_HEAT)
    for n in range(2, 7):
        layers[f"model{n}_1"] = _stageN(n, "L1", _N_PAF)
        layers[f"model{n}_2"] = _stageN(n, "L2", _N_HEAT)
    return layers


class OpenPoseNet(nn.Module):
    """The CNN; ``model0`` .. ``model6_2`` hold each block's convs by their
    reference names (JAX's tree)."""

    def __init__(self, *, dtype=torch.float32, device="cuda"):
        super().__init__()
        for block, layers in _all_layers().items():
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
        """x: (B, H, W, 3) BGR in [-0.5, 0.5] (im / 256 - 0.5). Returns
        (paf (B, H/8, W/8, 38), heatmap (B, H/8, W/8, 19))."""
        feat = self._run_block("model0", x, final_no_relu=False, impl=impl)
        paf = self._run_block("model1_1", feat, final_no_relu=True,
                              impl=impl)
        heat = self._run_block("model1_2", feat, final_no_relu=True,
                               impl=impl)
        for n in range(2, 7):
            inp = torch.cat([paf, heat, feat], dim=-1)
            paf = self._run_block(f"model{n}_1", inp, final_no_relu=True,
                                  impl=impl)
            # reference quirk: its no_relu_layers list names
            # Mconv7_stage6_L1 twice and omits Mconv7_stage6_L2, so the last
            # stage's heatmap IS relu'd; the shipped weights were trained
            # against that graph
            heat = self._run_block(f"model{n}_2", inp,
                                   final_no_relu=(n != 6), impl=impl)
        return paf, heat


def init_openpose(seed: int = 0, *, dtype=torch.float32,
                  device="cuda") -> OpenPoseNet:
    """The CNN with seeded random weights (fan-in normal, zero biases)."""
    from idmvton_tpu_torch.models.layers import reset_parameters_
    net = OpenPoseNet(dtype=dtype, device=device)
    reset_parameters_(net, torch.Generator(device=device).manual_seed(seed))
    return net


def convert_openpose(sd, dtype=torch.float32, *, strict: bool = False
                     ) -> dict:
    """torch state dict (keys 'model0.conv1_1.weight', ...) -> the CNN's
    tree (CPU tensors, JAX's key names)."""
    from idmvton_tpu_torch.preprocess.densepose.convert import conv_leaf
    params = {}
    used = set()
    for block, layers in _all_layers().items():
        params[block] = {}
        for name, _, _, _ in layers:
            w, b = f"{block}.{name}.weight", f"{block}.{name}.bias"
            used.update((w, b))
            params[block][name] = conv_leaf(sd[w], sd[b], dtype)
    if strict:
        from idmvton_tpu_torch.weights.converter import check_consumed
        check_consumed(sd, used)
    return params


# ---------------------------------------------------------------------------
# decode: peaks + PAF bipartite matching (host-side numpy)
# ---------------------------------------------------------------------------

# limb sequence and the PAF channel pairs for each limb (reference body.py)
_LIMB_SEQ = [
    (2, 3), (2, 6), (3, 4), (4, 5), (6, 7), (7, 8), (2, 9), (9, 10),
    (10, 11), (2, 12), (12, 13), (13, 14), (2, 1), (1, 15), (15, 17),
    (1, 16), (16, 18), (3, 17), (6, 18),
]
_PAF_IDX = [
    (31, 32), (39, 40), (33, 34), (35, 36), (41, 42), (43, 44), (19, 20),
    (21, 22), (23, 24), (25, 26), (27, 28), (29, 30), (47, 48), (49, 50),
    (53, 54), (51, 52), (55, 56), (37, 38), (45, 46),
]


def _gaussian_smooth(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """``scipy.ndimage.gaussian_filter(x[..., c], sigma)`` of each channel of
    x (H, W, C) fp32, to the bit, on x's device: the same float64 weights
    (radius int(4 sigma + 0.5)), the same reflected edges, each axis in
    float64 in scipy's order (the centre tap, then the outermost pair in
    first) and rounded to fp32 between the axes."""
    r = int(4.0 * float(sigma) + 0.5)
    k = np.arange(-r, r + 1)
    phi = np.exp(-0.5 / (sigma * sigma) * k ** 2)
    w = (phi / phi.sum())[::-1].tolist()
    for axis in (0, 1):
        n = x.shape[axis]
        xd = x.double()
        pad = torch.cat([xd.narrow(axis, 0, r).flip(axis), xd,
                         xd.narrow(axis, n - r, r).flip(axis)], axis)
        out = pad.narrow(axis, r, n) * w[r]
        for j in range(-r, 0):
            out = out + (pad.narrow(axis, r + j, n)
                         + pad.narrow(axis, r - j, n)) * w[r + j]
        x = out.float()
    return x


def find_peaks(heatmap, *, threshold: float = 0.1, sigma: float = 3.0
               ) -> List[List[Tuple[int, int, float, int]]]:
    """heatmap (H, W, 19) fp32, a tensor (computed on its device) or an
    array (on the CPU). Returns per-part peak lists of (x, y, score,
    global_id), those of the reference's per-part scipy loop (body.py) to
    the bit: the 18 parts smoothed at once (``_gaussian_smooth``), the same
    four-neighbour comparisons against zero edges, the peaks in the same
    row-major order; one read of the peaks to the host."""
    heat = torch.as_tensor(heatmap)[..., :18]
    m = _gaussian_smooth(heat, sigma).permute(2, 0, 1)      # (18, H, W)
    up = F.pad(m[:, :-1], (0, 0, 1, 0))
    down = F.pad(m[:, 1:], (0, 0, 0, 1))
    left = F.pad(m[:, :, :-1], (1, 0))
    right = F.pad(m[:, :, 1:], (0, 1))
    is_peak = ((m >= up) & (m >= down) & (m >= left) & (m >= right)
               & (m > threshold))
    idx = torch.nonzero(is_peak)                            # (P, 3)
    scores = heat[idx[:, 1], idx[:, 2], idx[:, 0]]
    parts, ys, xs = idx.cpu().numpy().T.tolist() if len(idx) else ([],) * 3
    vals = scores.cpu().tolist()
    all_peaks = [[] for _ in range(18)]
    for i, (part, y, x, v) in enumerate(zip(parts, ys, xs, vals)):
        all_peaks[part].append((x, y, v, i))
    return all_peaks


def _pair_scores(paf, channels, cand_a, cand_b, *, img_h: int,
                 n_integral: int, score_thr: float):
    """The PAF line integral of every (a, b) candidate pair at once, each
    number computed as the reference's per-pair loop computes it (the same
    float32 / float64 operations in the same order, so the same bits), on
    the limb's two ``channels`` of ``paf`` (H, W, 38), read at the
    sampled points only. Returns [(i, j, mean_score, mean_score + score_a
    + score_b)] of the pairs that pass, in (i, j) order."""
    ax, ay, sa = (np.asarray([p[k] for p in cand_a]) for k in (0, 1, 2))
    bx, by, sb = (np.asarray([p[k] for p in cand_b]) for k in (0, 1, 2))
    dx = (bx[None, :] - ax[:, None]).astype(np.float32)      # (A, B)
    dy = (by[None, :] - ay[:, None]).astype(np.float32)
    # float32 squares and their sum are exact for pixel offsets
    norm = np.maximum(np.sqrt((dx * dx + dy * dy).astype(np.float64)),
                      1e-8)
    n32 = norm.astype(np.float32)
    v = np.stack([dx / n32, dy / n32], -1)                  # (A, B, 2)
    k = np.arange(n_integral, dtype=np.float64)

    def line(a, b):     # np.linspace(a, b, n_integral), per pair
        a = np.broadcast_to(a, dx.shape).astype(np.float64)
        b = np.broadcast_to(b, dx.shape).astype(np.float64)
        out = k * ((b - a) / (n_integral - 1))[..., None] + a[..., None]
        out[..., -1] = b
        return out

    xs = line(ax[:, None], bx[None, :])
    ys = line(ay[:, None], by[None, :])
    iy = np.round(ys).astype(int).clip(0, paf.shape[0] - 1)
    ix = np.round(xs).astype(int).clip(0, paf.shape[1] - 1)
    samples = paf[iy[..., None], ix[..., None],
                  np.asarray(channels)]                     # (A, B, n, 2)
    line_scores = np.matmul(samples, v[..., None])[..., 0]  # (A, B, n)
    prior = np.minimum(0.5 * img_h / norm - 1, 0.0)
    mean = line_scores.mean(axis=-1).astype(np.float64) + prior
    ok = (((line_scores > score_thr).sum(-1) > 0.8 * n_integral)
          & (mean > 0))
    ii, jj = np.nonzero(ok)
    m = mean[ii, jj]
    return list(zip(ii.tolist(), jj.tolist(), m.tolist(),
                    (m + sa[ii] + sb[jj]).tolist()))


def match_limbs(paf: np.ndarray, all_peaks, *, img_h: int,
                n_integral: int = 10, score_thr: float = 0.05):
    """PAF line-integral scoring + greedy bipartite matching per limb
    (reference body.py:77-139; the pairs of a limb scored at once,
    ``_pair_scores``). Returns (connections per limb)."""
    connections = []
    for limb_i, (pa, pb) in enumerate(_LIMB_SEQ):
        ca, cb = _PAF_IDX[limb_i]
        # mapIdx values are historical concat indices; PAF channel = idx - 19
        # (reference body.py score_mid indexing)
        cand_a = all_peaks[pa - 1]
        cand_b = all_peaks[pb - 1]
        if not cand_a or not cand_b:
            connections.append([])
            continue
        scored = _pair_scores(paf, (ca - 19, cb - 19), cand_a, cand_b,
                              img_h=img_h, n_integral=n_integral,
                              score_thr=score_thr)
        scored.sort(key=lambda t: t[2], reverse=True)
        used_a, used_b, conn = set(), set(), []
        for i, j, s, st in scored:
            if i not in used_a and j not in used_b:
                conn.append((cand_a[i][3], cand_b[j][3], s, i, j))
                used_a.add(i)
                used_b.add(j)
                if len(conn) >= min(len(cand_a), len(cand_b)):
                    break
        connections.append(conn)
    return connections


def assemble_people(all_peaks, connections):
    """Group limb connections into people (reference body.py:143-212).
    Returns subset (P, 20): 18 peak ids (-1 missing), score, count."""
    candidate = np.asarray([p for peaks in all_peaks for p in peaks],
                           np.float32).reshape(-1, 4)
    subset = np.empty((0, 20), np.float32)
    for limb_i, (pa, pb) in enumerate(_LIMB_SEQ):
        conn = connections[limb_i]
        if not conn:
            continue
        ia, ib = pa - 1, pb - 1
        for (ga, gb, score, _, _) in conn:
            found = [si for si in range(len(subset))
                     if subset[si][ia] == ga or subset[si][ib] == gb]
            if len(found) == 1:
                s = found[0]
                if subset[s][ib] != gb:
                    subset[s][ib] = gb
                    subset[s][-1] += 1
                    subset[s][-2] += candidate[int(gb), 2] + score
            elif len(found) == 2:
                s1, s2 = found
                overlap = ((subset[s1][:18] >= 0)
                           & (subset[s2][:18] >= 0)).sum()
                if overlap == 0:  # merge disjoint partial people
                    subset[s1][:18] = np.where(subset[s1][:18] < 0,
                                               subset[s2][:18], subset[s1][:18])
                    subset[s1][-2:] += subset[s2][-2:]
                    subset[s1][-2] += score
                    subset = np.delete(subset, s2, 0)
                else:
                    subset[s1][ib] = gb
                    subset[s1][-1] += 1
                    subset[s1][-2] += candidate[int(gb), 2] + score
            elif limb_i < 17:
                row = -1 * np.ones(20, np.float32)
                row[ia], row[ib] = ga, gb
                row[-1] = 2
                row[-2] = candidate[int(ga), 2] + candidate[int(gb), 2] + score
                subset = np.vstack([subset, row])
    # prune weak people
    keep = [i for i in range(len(subset))
            if subset[i][-1] >= 4 and subset[i][-2] / subset[i][-1] >= 0.4]
    return subset[keep], candidate


def resize_bilinear(x, hw):
    """NHWC bilinear resize with half-pixel centres (no antialiasing):
    ``jax.image.resize(..., "bilinear")`` for an upsampling."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


class OpenPose:
    """End-to-end wrapper: image -> 18 keypoints in (384, 512) coords.
    ``net`` defaults to the seeded random CNN on ``device``; ``impl`` is
    the conv sites' impl (None: follow the device)."""

    def __init__(self, net: Optional[OpenPoseNet] = None, *,
                 boxsize: int = 368, stride: int = 8, scales=(0.5,),
                 device="cuda", impl=None):
        self.net = net if net is not None else init_openpose(0,
                                                             device=device)
        self.boxsize = boxsize
        self.stride = stride
        self.scales = scales
        self.impl = impl

    @staticmethod
    def from_torch(path: str, dtype=torch.float32, *,
                   device="cuda") -> "OpenPose":
        from idmvton_tpu_torch.weights.converter import load_state_dict
        from idmvton_tpu_torch.weights.from_jax import load_module_params
        net = OpenPoseNet(dtype=dtype, device=device)
        load_module_params(net, convert_openpose(load_state_dict(path),
                                                 dtype))
        return OpenPose(net)

    def prepare(self, image_bgr: np.ndarray, scale: float):
        """The network input of one scale: OpenCV cubic resize, bottom /
        right padding with 128 to the stride. Returns (x (1, H, W, 3) in
        [-0.5, 0.5], (ph, pw))."""
        import cv2
        s = scale * self.boxsize / image_bgr.shape[0]
        im = cv2.resize(image_bgr, None, fx=s, fy=s,
                        interpolation=cv2.INTER_CUBIC)
        ph = (self.stride - im.shape[0] % self.stride) % self.stride
        pw = (self.stride - im.shape[1] % self.stride) % self.stride
        im = np.pad(im, ((0, ph), (0, pw), (0, 0)), mode="constant",
                    constant_values=128)
        return im.astype(np.float32)[None] / 256.0 - 0.5, (ph, pw)

    def maps(self, x: np.ndarray):
        """The CNN on one prepared input, its maps upsampled x8 to the
        input's size on the device: (paf, heat) numpy (H, W, C)."""
        dev = next(self.net.parameters()).device
        with torch.no_grad():
            paf, heat = self.net(torch.from_numpy(x).to(dev), impl=self.impl)
            size = x.shape[1:3]
            return (resize_bilinear(paf, size)[0].cpu().numpy(),
                    resize_bilinear(heat, size)[0].cpu().numpy())

    def heatmaps(self, image_bgr: np.ndarray):
        """image_bgr (H, W, 3) uint8. Multi-scale averaged (paf, heatmap) at
        image resolution. Each scale's input and CNN, up to the host's read
        of its maps, is the span ``openpose.net``; the resize back and the
        average are ``openpose.decode``, as is ``__call__``'s decode."""
        import cv2
        h, w = image_bgr.shape[:2]
        n = len(self.scales)
        if n > 1:
            heat_avg = np.zeros((h, w, _N_HEAT), np.float32)
            paf_avg = np.zeros((h, w, _N_PAF), np.float32)
        for scale in self.scales:
            with span("openpose.net"):
                x, (ph, pw) = self.prepare(image_bgr, scale)
                paf, heat = self.maps(x)
            with span("openpose.decode"):
                ih, iw = x.shape[1:3]
                paf = cv2.resize(paf[:ih - ph or None, :iw - pw or None],
                                 (w, h))
                heat = cv2.resize(heat[:ih - ph or None, :iw - pw or None],
                                  (w, h))
                if n == 1:      # the average of one map is the map
                    return paf, heat
                paf_avg += paf / n
                heat_avg += heat / n
        return paf_avg, heat_avg

    def __call__(self, image_rgb: np.ndarray) -> dict:
        """image_rgb (H, W, 3) uint8 -> {"pose_keypoints_2d": 18*2 floats}
        scaled to 384x512 (undetected joints = -1)."""
        h, w = image_rgb.shape[:2]
        image_bgr = image_rgb[:, :, ::-1]
        paf, heat = self.heatmaps(image_bgr)
        with span("openpose.decode"):
            dev = next(self.net.parameters()).device
            peaks = find_peaks(torch.from_numpy(heat).to(dev))
            conns = match_limbs(paf, peaks, img_h=h)
            subset, candidate = assemble_people(peaks, conns)
            kps = -np.ones((18, 2), np.float32)
            if len(subset):
                best = subset[np.argmax(subset[:, -2])]
                for part in range(18):
                    idx = int(best[part])
                    if idx >= 0:
                        kps[part] = candidate[idx, :2]
            # scale to the canonical 384x512 frame
            kps[kps[:, 0] >= 0] *= np.asarray([384.0 / w, 512.0 / h],
                                              np.float32)
        return {"pose_keypoints_2d": kps.reshape(-1).tolist()}
