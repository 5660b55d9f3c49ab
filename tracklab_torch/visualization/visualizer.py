"""Visualizer base classes, per-frame matching of predicted to ground-truth
boxes (IoU, Hungarian) and a color per track id (counterpart of
tracklab_tpu.visualization.visualizer)."""
from __future__ import annotations

import colorsys
from abc import ABC, abstractmethod

import numpy as np

__all__ = ["Visualizer", "ImageVisualizer", "DetectionVisualizer",
           "track_color", "match_pred_gt"]


def track_color(track_id) -> tuple:
    """Deterministic visually-distinct RGB color per track id."""
    if track_id is None or (isinstance(track_id, float)
                            and np.isnan(track_id)):
        return (128, 128, 128)
    h = (int(track_id) * 0.61803398875) % 1.0
    r, g, b = colorsys.hsv_to_rgb(h, 0.85, 0.95)
    return (int(r * 255), int(g * 255), int(b * 255))


def match_pred_gt(preds, gts, iou_threshold=0.5):
    """IoU + Hungarian matching of one frame's pred/GT boxes
    (visualizer.py:47-75). Inputs: (N, 4)/(M, 4) ltwh arrays. Returns
    pred2gt (N,) int, -1 unmatched."""
    from scipy.optimize import linear_sum_assignment
    n, m = len(preds), len(gts)
    out = np.full(n, -1, int)
    if n == 0 or m == 0:
        return out
    p = np.asarray(preds, float)
    g = np.asarray(gts, float)
    px2 = p[:, None, 0] + p[:, None, 2]
    py2 = p[:, None, 1] + p[:, None, 3]
    gx2 = g[None, :, 0] + g[None, :, 2]
    gy2 = g[None, :, 1] + g[None, :, 3]
    xx1 = np.maximum(p[:, None, 0], g[None, :, 0])
    yy1 = np.maximum(p[:, None, 1], g[None, :, 1])
    xx2 = np.minimum(px2, gx2)
    yy2 = np.minimum(py2, gy2)
    inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
    union = (p[:, None, 2] * p[:, None, 3]
             + g[None, :, 2] * g[None, :, 3] - inter)
    iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0)
    rows, cols = linear_sum_assignment(-iou)
    for r, c in zip(rows, cols):
        if iou[r, c] >= iou_threshold:
            out[r] = c
    return out


class Visualizer(ABC):
    """Base: draws in place on an RGB uint8 frame."""


class ImageVisualizer(Visualizer):
    @abstractmethod
    def draw_frame(self, image, detections_pred, detections_gt,
                   image_metadata):
        ...


class DetectionVisualizer(Visualizer):
    """Called once per (pred, matched-gt) detection pair; pred or gt may
    be None for FN/FP cases."""

    def draw_frame(self, image, detections_pred, detections_gt,
                   image_metadata):
        preds = list(detections_pred.iterrows()) \
            if detections_pred is not None else []
        gts = list(detections_gt.iterrows()) \
            if detections_gt is not None else []
        pred_boxes = [d["bbox_ltwh"] for _, d in preds]
        gt_boxes = [d["bbox_ltwh"] for _, d in gts]
        p2g = match_pred_gt(pred_boxes, gt_boxes)
        used_gt = set(p2g[p2g >= 0])
        for i, (_, det) in enumerate(preds):
            gt = gts[p2g[i]][1] if p2g[i] >= 0 else None
            self.draw_detection(image, det, gt)
        for j, (_, gt) in enumerate(gts):
            if j not in used_gt:
                self.draw_detection(image, None, gt)

    @abstractmethod
    def draw_detection(self, image, detection_pred, detection_gt):
        ...
