"""Agnostic-mask compositor: parse map + OpenPose keypoints -> inpaint mask.

A copy of ``idmvton_tpu/preprocess/agnostic_mask.py`` with OpenCV and PIL
imported inside the functions that use them (the port's modules import
neither). Host-side (numpy/cv2/PIL) port of the reference's mask composition
(reference: gradio_demo/utils_mask.py:54-167 get_mask_location) — the logic
is inherently sequential raster ops (flood fill, contours, polyline draws),
so it stays on CPU; it runs once per image, off the TPU hot path.

Semantics preserved:
- category-specific garment label sets ('upper_body'/'lower_body'/'dresses'),
- arm polylines shoulder->elbow->wrist with 1.2x wrist extrapolation and
  shoulder arc caps; hands (arm pixels beyond the drawn arm) are preserved,
- head/shoes/hat/sunglasses/bag (+ lower cloth for upper_body) never masked,
- neck (label 18) dilated into the mask minus the head,
- 5x5 dilation of the garment mask (5 iters), flood-fill hole closing and
  largest-contour refinement.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# ATR/SCHP 18-label scheme + synthesized neck label 18
# (reference: preprocess/humanparsing label maps; gradio_demo/utils_mask.py:5)
LABELS = {
    "background": 0, "hat": 1, "hair": 2, "sunglasses": 3, "upper_clothes": 4,
    "skirt": 5, "pants": 6, "dress": 7, "belt": 8, "left_shoe": 9,
    "right_shoe": 10, "head": 11, "left_leg": 12, "right_leg": 13,
    "left_arm": 14, "right_arm": 15, "bag": 16, "scarf": 17, "neck": 18,
}

_HEAD_LABELS = ("hat", "sunglasses", "head")
_FIXED_LABELS = ("left_shoe", "right_shoe", "hat", "sunglasses", "bag")
_GARMENT_LABELS = {
    "upper_body": ("upper_clothes", "dress"),
    "lower_body": ("pants", "left_leg", "right_leg", "skirt"),
    "dresses": ("dress", "upper_clothes", "skirt", "pants"),
}


def _labels_mask(parse: np.ndarray, names) -> np.ndarray:
    out = np.zeros(parse.shape, np.float32)
    for n in names:
        out += (parse == LABELS[n]).astype(np.float32)
    return out


def _fill_holes(binary: np.ndarray) -> np.ndarray:
    """Close interior holes: flood the background from the border and OR the
    non-reachable interior back in (reference: utils_mask.py:30 hole_fill)."""
    import cv2
    img = np.pad(binary[1:-1, 1:-1], 1, mode="constant").astype(np.uint8)
    keep = img.copy()
    flood_mask = np.zeros((img.shape[0] + 2, img.shape[1] + 2), np.uint8)
    cv2.floodFill(img, flood_mask, (0, 0), 255)
    return cv2.bitwise_or(keep, cv2.bitwise_not(img))


def _largest_component(binary: np.ndarray) -> np.ndarray:
    """Keep only the largest contour, filled (utils_mask.py:40 refine_mask)."""
    import cv2
    contours, _ = cv2.findContours(binary.astype(np.uint8), cv2.RETR_CCOMP,
                                   cv2.CHAIN_APPROX_TC89_L1)
    out = np.zeros_like(binary, np.uint8)
    if contours:
        areas = [abs(cv2.contourArea(c, True)) for c in contours]
        cv2.drawContours(out, contours, int(np.argmax(areas)), 255, -1)
    return out


def _draw_arm(size_hw: Tuple[int, int], points, line_width: int,
              shoulder_box) -> np.ndarray:
    """White polyline through (shoulder, elbow, extended wrist) with rounded
    joints + a shoulder arc cap, as the reference draws with PIL."""
    from PIL import Image, ImageDraw
    h, w = size_hw
    img = Image.new("L", (w, h))
    draw = ImageDraw.Draw(img)
    flat = np.asarray([v for pt in points for v in pt], np.float32)
    # uint16 cast (with wraparound) matches the reference's coordinate
    # quantization (utils_mask.py:141)
    draw.line(flat.astype(np.uint16).tolist(), "white", line_width, "curve")
    draw.arc(shoulder_box, 0, 360, "white", line_width // 2)
    return np.asarray(img)


def get_mask_location(model_type: str, category: str, model_parse,
                      keypoint: Dict, width: int = 384, height: int = 512
                      ) -> Tuple[Image.Image, Image.Image]:
    """Returns (binary mask PIL, gray preview PIL) at (width, height).

    model_parse: PIL image or (H, W) int array of parse labels;
    keypoint: {"pose_keypoints_2d": flat list} in 384x512 coords.
    """
    import cv2
    from PIL import Image
    if isinstance(model_parse, Image.Image):
        parse = np.asarray(model_parse.resize((width, height), Image.NEAREST))
    else:
        parse = np.asarray(model_parse)
        if parse.shape != (height, width):
            parse = np.asarray(Image.fromarray(parse.astype(np.uint8))
                               .resize((width, height), Image.NEAREST))

    if model_type == "hd":
        arm_width = 60
    elif model_type == "dc":
        arm_width = 45
    else:
        raise ValueError("model_type must be 'hd' or 'dc'")
    if category not in _GARMENT_LABELS:
        raise NotImplementedError(category)

    head = _labels_mask(parse, _HEAD_LABELS)
    fixed = _labels_mask(parse, _FIXED_LABELS)
    changeable = (parse == LABELS["background"]).astype(np.float32)
    arms_left = (parse == LABELS["left_arm"]).astype(np.float32)
    arms_right = (parse == LABELS["right_arm"]).astype(np.float32)

    garment = _labels_mask(parse, _GARMENT_LABELS[category])
    if category == "upper_body":
        fixed += _labels_mask(parse, ("skirt", "pants"))
    elif category == "lower_body":
        fixed += _labels_mask(parse, ("upper_clothes", "left_arm", "right_arm"))
    changeable += np.logical_and(parse, np.logical_not(fixed))

    pose = np.asarray(keypoint["pose_keypoints_2d"], np.float32).reshape(-1, 2)
    scale = height / 512.0

    arm_imgs = {"left": arms_left, "right": arms_right}
    if category in ("dresses", "upper_body"):
        line_w = int(arm_width / 512 * height)
        for side, (sh_i, el_i, wr_i) in (("right", (2, 3, 4)),
                                         ("left", (5, 6, 7))):
            shoulder = pose[sh_i] * scale
            elbow = pose[el_i] * scale
            wrist = pose[wr_i] * scale
            if wrist[0] <= 1.0 and wrist[1] <= 1.0:
                continue  # wrist not detected: keep the parsed arm pixels
            wrist_ext = elbow + 1.2 * (wrist - elbow)
            pts = ([shoulder, elbow, wrist_ext] if side == "right"
                   else [wrist_ext, elbow, shoulder])
            box = [shoulder[0] - line_w // 2, shoulder[1] - line_w // 2,
                   shoulder[0] + line_w // 2, shoulder[1] + line_w // 2]
            arm_imgs[side] = _draw_arm((height, width), pts, line_w, box)
        hands = (np.logical_and(np.logical_not(arm_imgs["left"]), arms_left)
                 + np.logical_and(np.logical_not(arm_imgs["right"]), arms_right))
        fixed += hands

    fixed = np.logical_or(fixed, head)
    garment = cv2.dilate(garment, np.ones((5, 5), np.uint16), iterations=5)
    if category in ("dresses", "upper_body"):
        neck = (parse == LABELS["neck"]).astype(np.float32)
        neck = cv2.dilate(neck, np.ones((5, 5), np.uint16), iterations=1)
        neck = np.logical_and(neck, np.logical_not(head))
        garment = np.logical_or(garment, neck)
        arm_union = np.logical_or(arm_imgs["left"], arm_imgs["right"])
        arm_union = cv2.dilate(arm_union.astype(np.float32),
                               np.ones((5, 5), np.uint16), iterations=4)
        garment = garment + np.logical_or(garment, arm_union)

    keep = np.logical_and(changeable, np.logical_not(garment))
    keep_total = np.logical_or(keep, fixed)
    inpaint = np.where(np.logical_not(keep_total), 255, 0).astype(np.uint8)
    inpaint = _largest_component(_fill_holes(inpaint))
    binary = (inpaint // 255).astype(np.uint8)
    return (Image.fromarray(binary * 255),
            Image.fromarray(binary * 127))
