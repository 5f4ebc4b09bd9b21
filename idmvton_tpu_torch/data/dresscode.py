"""DressCode dataset: per-category try-on samples with on-the-fly agnostic
masks (reference: inference_dc.py DresscodeTestDataset :96-348).

Layout: {root}/{category}/ with images/, label_maps/ (*_4.png), keypoints/
(*_2.json), skeletons/ (*_5.jpg), image-densepose/, {phase}_pairs_{order}.txt,
dc_caption.txt. Categories: upper_body / lower_body / dresses. OpenCV and
PIL are imported by the functions that need them.

Own copy of ``idmvton_tpu/data/dresscode.py`` for the PyTorch port, which
imports nothing of the JAX package; tests hold the two bit for bit.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from idmvton_tpu_torch.data.image import normalize_pm1, clip_preprocess

CATEGORIES = ("upper_body", "lower_body", "dresses")

_L = {  # DressCode label map (reference: inference_dc.py:49-68)
    "background": 0, "hat": 1, "hair": 2, "sunglasses": 3, "upper_clothes": 4,
    "skirt": 5, "pants": 6, "dress": 7, "belt": 8, "left_shoe": 9,
    "right_shoe": 10, "head": 11, "left_leg": 12, "right_leg": 13,
    "left_arm": 14, "right_arm": 15, "bag": 16, "scarf": 17,
}


def _mask_of(parse, names):
    out = np.zeros(parse.shape, np.float32)
    for n in names:
        out += (parse == _L[n]).astype(np.float32)
    return out


def dresscode_keep_mask(parse_array: np.ndarray, pose_data: np.ndarray,
                        category: str, size: Tuple[int, int]) -> np.ndarray:
    """Returns the KEEP mask (1 = preserve pixel) — the reference's
    ``get_agnostic`` (inference_dc.py:231-348): category garment masks, a
    single joined arm polyline, neck deletion below the least-squares
    shoulder line, resolution-dependent dilation."""
    import cv2
    from PIL import Image, ImageDraw
    width, height = size
    parse = parse_array
    head = _mask_of(parse, ("hat", "hair", "sunglasses", "head"))
    fixed = _mask_of(parse, ("hair", "left_shoe", "right_shoe", "hat",
                             "sunglasses", "scarf", "bag"))
    changeable = (parse == 0).astype(np.float32)
    arms = _mask_of(parse, ("left_arm", "right_arm"))

    if category == "dresses":
        garment = _mask_of(parse, ("dress", "left_leg", "right_leg"))
    elif category == "upper_body":
        garment = _mask_of(parse, ("upper_clothes",))
        fixed += _mask_of(parse, ("skirt", "pants"))
    elif category == "lower_body":
        garment = _mask_of(parse, ("pants", "left_leg", "right_leg"))
        fixed += _mask_of(parse, ("upper_clothes", "left_arm", "right_arm"))
    else:
        raise NotImplementedError(category)
    changeable += np.logical_and(parse, np.logical_not(fixed))

    sc = height / 512.0
    if category in ("dresses", "upper_body"):
        # joined arm polyline: drop undetected wrists/elbows from the chain
        kp = {name: pose_data[i, :2] * sc for name, i in
              (("sr", 2), ("el_r", 3), ("wr_r", 4),
               ("sl", 5), ("el_l", 6), ("wr_l", 7))}
        missing = lambda p: p[0] <= 1.0 and p[1] <= 1.0
        chain = []
        if not missing(kp["wr_l"]):
            chain.append(kp["wr_l"])
        if not (missing(kp["wr_l"]) and missing(kp["el_l"])):
            chain.append(kp["el_l"])
        chain += [kp["sl"], kp["sr"]]
        if not (missing(kp["wr_r"]) and missing(kp["el_r"])):
            chain.append(kp["el_r"])
        if not missing(kp["wr_r"]):
            chain.append(kp["wr_r"])
        im_arms = Image.new("L", (width, height))
        ImageDraw.Draw(im_arms).line(
            [tuple(map(float, p)) for p in chain], "white", 30, "curve")
        im_arms = np.float32(im_arms)
        if height > 512:
            im_arms = cv2.dilate(im_arms, np.ones((10, 10), np.uint16),
                                 iterations=5)
        elif height > 256:
            im_arms = cv2.dilate(im_arms, np.ones((5, 5), np.uint16),
                                 iterations=5)
        hands = np.logical_and(np.logical_not(im_arms), arms)
        garment += im_arms
        fixed += hands

    # neck deletion: zero the head mask below the shoulder line minus 20px
    head_kept = head.copy()
    if category in ("dresses", "upper_body"):
        pts = [pose_data[2, :2] * sc, pose_data[5, :2] * sc]
        xs, ys = zip(*pts)
        a = np.vstack([xs, np.ones(len(xs))]).T
        m, c = np.linalg.lstsq(a, ys, rcond=None)[0]
        for i in range(parse.shape[1]):
            y = i * m + c
            head_kept[int(y - 20 * sc):, i] = 0

    fixed = np.logical_or(fixed, head_kept.astype(np.uint16))
    garment = garment + np.logical_or(
        garment, np.logical_and(head.astype(np.uint16),
                                np.logical_not(head_kept.astype(np.uint16))))

    if height > 512:
        kernel, iters = np.ones((20, 20), np.uint16), 5
    elif height > 256:
        kernel, iters = np.ones((10, 10), np.uint16), 5
    else:
        kernel, iters = np.ones((5, 5), np.uint16), 5
    garment = cv2.dilate(garment, kernel, iterations=iters)
    keep = np.logical_and(changeable, np.logical_not(garment))
    return np.logical_or(keep, fixed).astype(np.float32)


class DressCodeDataset:
    """Sample dict contract identical to VitonHDDataset (datasets.py)."""

    def __init__(self, dataroot: str, *, category: str = "upper_body",
                 phase: str = "test", order: str = "paired",
                 size: Tuple[int, int] = (1024, 768)):
        assert category in CATEGORIES, category
        self.root = os.path.join(dataroot, category)
        self.category = category
        self.height, self.width = size

        pairs = (os.path.join(self.root, f"{phase}_pairs_{order}.txt")
                 if phase == "test"
                 else os.path.join(self.root, f"{phase}_pairs.txt"))
        self.im_names, self.c_names = [], []
        with open(pairs) as f:
            for line in f:
                parts = line.strip().split()
                if parts:
                    self.im_names.append(parts[0])
                    self.c_names.append(parts[1])

        self.annotation = {}
        cap = os.path.join(self.root, "dc_caption.txt")
        if os.path.exists(cap):
            with open(cap) as f:
                for line in f:
                    parts = line.strip().split(" ")
                    self.annotation[parts[0]] = " ".join(parts[1:])

    def __len__(self):
        return len(self.im_names)

    def __getitem__(self, index: int) -> dict:
        from PIL import Image
        im_name = self.im_names[index]
        c_name = self.c_names[index]
        annotation = self.annotation.get(c_name, self.category)
        size = (self.width, self.height)

        cloth_pil = Image.open(os.path.join(self.root, "images", c_name))
        person = normalize_pm1(
            Image.open(os.path.join(self.root, "images", im_name)), size)
        pose = normalize_pm1(Image.open(
            os.path.join(self.root, "image-densepose", im_name)), size)
        cloth = normalize_pm1(cloth_pil, size)

        parse = Image.open(os.path.join(
            self.root, "label_maps", im_name.replace("_0.jpg", "_4.png")))
        parse = np.asarray(parse.resize(size, Image.NEAREST))
        with open(os.path.join(self.root, "keypoints",
                               im_name.replace("_0.jpg", "_2.json"))) as f:
            pose_data = np.asarray(json.load(f)["keypoints"],
                                   np.float32).reshape(-1, 4)

        keep = dresscode_keep_mask(parse, pose_data, self.category, size)
        mask = (1.0 - keep)[..., None].astype(np.float32)

        return {
            "im_name": im_name,
            "c_name": c_name,
            "person": person.astype(np.float32),
            "mask": mask,
            "pose": pose.astype(np.float32),
            "cloth": cloth.astype(np.float32),
            "ip_pixels": clip_preprocess(cloth_pil).astype(np.float32),
            "caption": "model is wearing a " + annotation,
            "caption_cloth": "a photo of " + annotation,
        }
