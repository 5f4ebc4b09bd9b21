"""The host C++ runtime (``csrc/native.cc``), built with g++ at first use
and bound with ctypes.

Counterpart of ``idmvton_tpu/runtime/native.py``: the ROIAlign oracle,
greedy NMS, a compact COCO AP and the pycocotools-parity COCO box
evaluator, on numpy arrays. The C++ bodies are the JAX package's; the glue
is a plain C interface, so the build needs no Python headers and loads as a
library of its own name (``libidmvton_native_<hash>.so``), never as an
extension module that another package's could shadow.

The library is built into ``idmvton_tpu_torch/_build/``, named by a hash of
the source and flags, through a temporary file and ``os.replace`` (several
processes may build at once); a library that is there already is reused.
Nothing is built at import. A missing ``g++`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "native.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> (argtypes, restype)
SIGNATURES = {
    # features, boxes, box_indices, out, B, H, W, C, R, n, sampling, scale,
    # aligned
    "idm_roi_align_forward": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               ctypes.c_float, _I], None),
    # boxes, scores, keep, N, threshold
    "idm_nms": ([_P, _P, _P, _I, ctypes.c_float], None),
    # dets, gts, D, G
    "idm_coco_average_precision": ([_P, _P, _I, _I], ctypes.c_double),
    # dets, gts, img_ids, cat_ids, iou_thrs, rec_thrs, area_rngs, max_dets,
    # precision, recall, scores, D, G, I, K, T, R, A, M
    "idm_coco_evaluate": ([_P] * 11 + [_I] * 8, None),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libidmvton_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/native.cc`` with g++ (once: a built library is
    reused)."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host runtime builds with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}_{threading.get_ident()}.tmp")
    try:
        subprocess.run([gxx, *FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{e.stderr}") \
            from None
    finally:
        tmp.unlink(missing_ok=True)
    return out


def get_native() -> ctypes.CDLL:
    """The bound library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = handle
        return _lib


def _ptr(a: np.ndarray, dtype, shape=None) -> int:
    """The data pointer of ``a`` after checking that it is a C-contiguous
    array of ``dtype`` (and ``shape``)."""
    if not (isinstance(a, np.ndarray) and a.dtype == dtype
            and a.flags.c_contiguous):
        raise ValueError(f"expected a C-contiguous {np.dtype(dtype)} array")
    if shape is not None and a.shape != tuple(shape):
        raise ValueError(f"expected shape {tuple(shape)}, got {a.shape}")
    return a.ctypes.data


def roi_align_cpu(features: np.ndarray, boxes: np.ndarray,
                  box_indices: np.ndarray, *, output_size: int,
                  spatial_scale: float = 1.0, sampling_ratio: int = 2,
                  aligned: bool = True) -> np.ndarray:
    """features (B, H, W, C) f32; boxes (R, 4); box_indices (R,) i32."""
    nat = get_native()
    features = np.ascontiguousarray(features, np.float32)
    b, h, w, c = features.shape
    boxes = np.ascontiguousarray(boxes, np.float32).reshape(-1, 4)
    r = boxes.shape[0]
    box_indices = np.ascontiguousarray(box_indices, np.int32)
    out = np.zeros((r, output_size, output_size, c), np.float32)
    nat.idm_roi_align_forward(
        _ptr(features, np.float32), _ptr(boxes, np.float32),
        _ptr(box_indices, np.int32, (r,)), _ptr(out, np.float32), b, h, w, c,
        r, output_size, sampling_ratio, float(spatial_scale), int(aligned))
    return out


def nms_cpu(boxes: np.ndarray, scores: np.ndarray,
            iou_threshold: float = 0.5) -> np.ndarray:
    """Returns bool keep mask (N,)."""
    nat = get_native()
    boxes = np.ascontiguousarray(boxes, np.float32).reshape(-1, 4)
    n = boxes.shape[0]
    scores = np.ascontiguousarray(scores, np.float32)
    keep = np.zeros((n,), np.int32)
    nat.idm_nms(_ptr(boxes, np.float32), _ptr(scores, np.float32, (n,)),
                _ptr(keep, np.int32), n, float(iou_threshold))
    return keep.astype(bool)


_COCO_AREA_RNGS = np.array(
    [[0.0, 1e10], [0.0, 32.0 ** 2], [32.0 ** 2, 96.0 ** 2], [96.0 ** 2, 1e10]])
_COCO_MAX_DETS = np.array([1, 10, 100], np.int32)


def coco_evaluate(detections: np.ndarray, ground_truths: np.ndarray, *,
                  iou_thrs: Optional[np.ndarray] = None,
                  rec_thrs: Optional[np.ndarray] = None,
                  area_rngs: Optional[np.ndarray] = None,
                  max_dets: Optional[np.ndarray] = None,
                  img_ids: Optional[np.ndarray] = None,
                  cat_ids: Optional[np.ndarray] = None) -> dict:
    """Full COCO box evaluation, pycocotools-parity accumulate / summarize
    (the reference's vendored cocoeval.cpp at its defaults: IoU thresholds
    .5:.05:.95, 101 recall points, area ranges all / small / medium /
    large, maxDets 1 / 10 / 100).

    detections (D, >=7): [image_id, cat_id, score, x1, y1, x2, y2]
      (optional col 7 = area; defaults to box area).
    ground_truths (G, >=6): [image_id, cat_id, iscrowd, x1, y1, x2, y2]
      (optional col 7 = explicit ignore, col 8 = area; default box area).

    Returns {"precision": (T,R,K,A,M), "recall": (T,K,A,M),
             "scores": (T,R,K,A,M), "stats": the 12 COCO summary numbers}.
    """
    nat = get_native()
    det = np.asarray(detections, np.float64)
    det = det.reshape(-1, det.shape[-1] if det.size else 7)
    gt = np.asarray(ground_truths, np.float64)
    gt = gt.reshape(-1, gt.shape[-1] if gt.size else 6)

    def _box_area(rows, off):
        return np.maximum(rows[:, off + 2] - rows[:, off], 0) * \
            np.maximum(rows[:, off + 3] - rows[:, off + 1], 0)

    d8 = np.zeros((len(det), 8))
    if len(det):
        d8[:, :3] = det[:, :3]
        d8[:, 4:8] = det[:, 3:7]
        d8[:, 3] = det[:, 7] if det.shape[1] > 7 else _box_area(det, 3)
    g9 = np.zeros((len(gt), 9))
    if len(gt):
        g9[:, :3] = gt[:, :3]
        g9[:, 5:9] = gt[:, 3:7]
        g9[:, 3] = gt[:, 7] if gt.shape[1] > 7 else 0.0
        g9[:, 4] = gt[:, 8] if gt.shape[1] > 8 else _box_area(gt, 3)

    f64 = lambda a: np.ascontiguousarray(a, np.float64)
    iou_thrs = np.linspace(.5, .95, 10) if iou_thrs is None else f64(iou_thrs)
    rec_thrs = np.linspace(0., 1., 101) if rec_thrs is None else f64(rec_thrs)
    area_rngs = _COCO_AREA_RNGS if area_rngs is None \
        else f64(area_rngs).reshape(-1, 2)
    max_dets = _COCO_MAX_DETS if max_dets is None \
        else np.ascontiguousarray(max_dets, np.int32)
    ids = np.concatenate([d8[:, 0], g9[:, 0]])
    img_ids = np.unique(ids) if img_ids is None else f64(img_ids)
    cats = np.concatenate([d8[:, 1], g9[:, 1]])
    cat_ids = np.unique(cats) if cat_ids is None else f64(cat_ids)

    T, R, K, A, M = (len(iou_thrs), len(rec_thrs), len(cat_ids),
                     len(area_rngs), len(max_dets))
    if M == 0:
        raise ValueError("max_dets is empty")
    precision = np.full((T, R, K, A, M), -1.0)
    recall = np.full((T, K, A, M), -1.0)
    scores = np.full((T, R, K, A, M), -1.0)
    nat.idm_coco_evaluate(
        _ptr(d8, np.float64), _ptr(g9, np.float64),
        _ptr(img_ids, np.float64), _ptr(cat_ids, np.float64),
        _ptr(iou_thrs, np.float64), _ptr(rec_thrs, np.float64),
        _ptr(area_rngs, np.float64, (A, 2)), _ptr(max_dets, np.int32),
        _ptr(precision, np.float64), _ptr(recall, np.float64),
        _ptr(scores, np.float64),
        len(d8), len(g9), len(img_ids), K, T, R, A, M)

    def _mean(x):
        x = x[x > -1]
        return float(x.mean()) if x.size else -1.0

    m_last = M - 1
    stats = np.array([
        _mean(precision[:, :, :, 0, m_last]),
        _mean(precision[iou_thrs == .5][:, :, :, 0, m_last])
        if (iou_thrs == .5).any() else -1.0,
        _mean(precision[iou_thrs == .75][:, :, :, 0, m_last])
        if (iou_thrs == .75).any() else -1.0,
        _mean(precision[:, :, :, 1, m_last]) if A > 3 else -1.0,
        _mean(precision[:, :, :, 2, m_last]) if A > 3 else -1.0,
        _mean(precision[:, :, :, 3, m_last]) if A > 3 else -1.0,
        _mean(recall[:, :, 0, 0]),
        _mean(recall[:, :, 0, 1]) if M > 1 else -1.0,
        _mean(recall[:, :, 0, m_last]),
        _mean(recall[:, :, 1, m_last]) if A > 3 else -1.0,
        _mean(recall[:, :, 2, m_last]) if A > 3 else -1.0,
        _mean(recall[:, :, 3, m_last]) if A > 3 else -1.0,
    ])
    return {"precision": precision, "recall": recall, "scores": scores,
            "stats": stats}


def coco_ap(detections: np.ndarray, ground_truths: np.ndarray) -> float:
    """detections (D, 6): [image_id, score, x1, y1, x2, y2];
    ground_truths (G, 5): [image_id, x1, y1, x2, y2]. Returns AP@[.5:.95]."""
    nat = get_native()
    det = np.ascontiguousarray(detections, np.float32).reshape(-1, 6)
    det = np.ascontiguousarray(det[np.argsort(-det[:, 1])]) if len(det) \
        else det
    gt = np.ascontiguousarray(ground_truths, np.float32).reshape(-1, 5)
    return float(nat.idm_coco_average_precision(
        _ptr(det, np.float32), _ptr(gt, np.float32), len(det), len(gt)))
