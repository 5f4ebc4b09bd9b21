"""Detection evaluation harness (the detectron2 evaluation stack's
contract on the port).

Counterpart of ``idmvton_tpu/preprocess/densepose/evaluate.py``: the
reference's ``inference_on_dataset`` (detectron2 evaluation/evaluator.py:102)
drives a model over a dataset and feeds a ``COCOEvaluator``
(coco_evaluation.py:33) whose process / evaluate protocol accumulates
per-image predictions and summarizes with the native cocoeval. Here the
static-shape DensePose R-CNN (``rcnn.py``, through ``DensePose.detect``)
gives fixed-count masked detections; the evaluator keeps the valid ones
and scores them with the C++ evaluator (``runtime.native.coco_evaluate``,
pycocotools-parity accumulate / summarize).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import numpy as np

from idmvton_tpu_torch.runtime.native import coco_evaluate

# COCO "person": the DensePose R-CNN is single-class (NUM_CLASSES: 1)
PERSON_CAT_ID = 1


class DetectionEvaluator:
    """process / evaluate accumulation protocol, mirroring COCOEvaluator
    (coco_evaluation.py:152 process, :176 evaluate): call ``process`` once
    per image with predictions and ground truth, then ``evaluate`` for the
    12 COCO summary numbers."""

    def __init__(self, cat_id: int = PERSON_CAT_ID):
        self.cat_id = cat_id
        self._dets: list = []
        self._gts: list = []
        self._n_images = 0

    def process(self, image_id: int, boxes, scores, gt_boxes,
                valid=None, iscrowd=None) -> None:
        """boxes (K, 4) xyxy + scores (K,) predictions (K may be the static
        detection count: pass ``valid`` to mask padding rows); gt_boxes
        (G, 4) xyxy ground truth for the same image."""
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        scores = np.asarray(scores, np.float32).reshape(-1)
        if valid is None:
            valid = np.ones(len(boxes), bool)
        for b, s, v in zip(boxes, scores, np.asarray(valid, bool)):
            if v:
                self._dets.append([image_id, self.cat_id, float(s), *b])
        gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
        if iscrowd is None:
            iscrowd = np.zeros(len(gt_boxes), np.float32)
        for b, c in zip(gt_boxes, np.asarray(iscrowd, np.float32)):
            self._gts.append([image_id, self.cat_id, float(c), *b])
        self._n_images += 1

    def evaluate(self) -> dict:
        """Returns coco_evaluate's dict ({"stats": 12 COCO numbers, ...})
        plus "n_images". stats[0] is AP@[.5:.95]."""
        dets = (np.asarray(self._dets, np.float32)
                if self._dets else np.zeros((0, 7), np.float32))
        gts = (np.asarray(self._gts, np.float32)
               if self._gts else np.zeros((0, 7), np.float32))
        out = coco_evaluate(dets, gts)
        out["n_images"] = self._n_images
        return out


def inference_on_dataset(
    model: Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray, np.ndarray]],
    dataset: Iterable[Tuple[int, np.ndarray, np.ndarray]],
    evaluator: Optional[DetectionEvaluator] = None,
) -> dict:
    """Drive ``model`` over ``dataset`` and score (evaluator.py:102).

    model: image_rgb -> (boxes (K, 4) xyxy in image coords, scores (K,),
    valid (K,) bool), e.g. ``DensePose(...).detect``.
    dataset: iterable of (image_id, image_rgb, gt_boxes (G, 4) xyxy).
    """
    ev = evaluator if evaluator is not None else DetectionEvaluator()
    for image_id, image, gt_boxes in dataset:
        boxes, scores, valid = model(image)
        ev.process(image_id, boxes, scores, gt_boxes, valid=valid)
    return ev.evaluate()
