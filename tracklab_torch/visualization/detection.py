"""Detection visualizers: boxes, foot ellipses, TP/FP/FN against the
ground truth, per-detection stats and ignore-region shading (counterpart
of tracklab_tpu.visualization.detection)."""
from __future__ import annotations

import numpy as np

from tracklab_torch.utils.cv2 import draw_bbox, draw_text
from tracklab_torch.visualization.visualizer import (
    DetectionVisualizer, track_color,
)

__all__ = ["DefaultDetectionVisualizer", "EllipseDetectionVisualizer",
           "DebugDetectionVisualizer"]


def _tid(det):
    v = det.get("track_id") if det is not None else None
    if v is None or (isinstance(v, float) and np.isnan(v)):
        return None
    return int(v)


class DefaultDetectionVisualizer(DetectionVisualizer):
    def __init__(self, print_id: bool = True, print_conf: bool = False,
                 **kwargs):
        self.print_id = print_id
        self.print_conf = print_conf

    def draw_detection(self, image, detection_pred, detection_gt):
        if detection_pred is None:
            return
        tid = _tid(detection_pred)
        color = track_color(tid)
        text = None
        if self.print_id and tid is not None:
            text = str(tid)
        if self.print_conf and "bbox_conf" in detection_pred:
            conf = float(detection_pred["bbox_conf"])
            text = (text + f" {conf:.2f}") if text else f"{conf:.2f}"
        box = detection_pred.get("track_bbox_ltwh",
                                 detection_pred.get("bbox_ltwh"))
        if box is not None:
            draw_bbox(image, box, color=color, text=text)


class EllipseDetectionVisualizer(DetectionVisualizer):
    """Foot-position ellipse under each box (soccer broadcast style)."""

    def draw_detection(self, image, detection_pred, detection_gt):
        import cv2
        if detection_pred is None:
            return
        box = detection_pred.get("track_bbox_ltwh",
                                 detection_pred.get("bbox_ltwh"))
        if box is None:
            return
        l, t, w, h = [float(v) for v in box]
        color = track_color(_tid(detection_pred))
        center = (int(l + w / 2), int(t + h))
        axes = (max(int(w / 2), 2), max(int(w / 8), 2))
        cv2.ellipse(image, center, axes, 0, -45, 235, color, 2,
                    cv2.LINE_AA)
        tid = _tid(detection_pred)
        if tid is not None:
            draw_text(image, str(tid), (center[0] - 8, center[1] + 4),
                      color=(255, 255, 255), bg_color=color)


class DebugDetectionVisualizer(DetectionVisualizer):
    """TP green / FP red / FN orange with GT boxes dashed-ish."""

    TP = (40, 200, 40)
    FP = (230, 50, 50)
    FN = (255, 165, 0)

    def draw_detection(self, image, detection_pred, detection_gt):
        if detection_pred is not None:
            color = self.TP if detection_gt is not None else self.FP
            box = detection_pred.get("track_bbox_ltwh",
                                     detection_pred.get("bbox_ltwh"))
            tid = _tid(detection_pred)
            draw_bbox(image, box, color=color,
                      text=None if tid is None else str(tid))
        elif detection_gt is not None:
            draw_bbox(image, detection_gt["bbox_ltwh"], color=self.FN,
                      thickness=1, text="FN")


class DetectionStatsVisualizer(DetectionVisualizer):
    """Prints per-detection stats next to each box (confidence, track
    costs when present) — the reference's per-detection debug printer
    (tracklab/visualization/detection.py stats zoo)."""

    def __init__(self, fields=("bbox_conf", "track_bbox_conf"), **kwargs):
        self.fields = list(fields)

    def draw_detection(self, image, detection_pred, detection_gt):
        if detection_pred is None:
            return
        box = detection_pred.get("track_bbox_ltwh",
                                 detection_pred.get("bbox_ltwh"))
        if box is None:
            return
        lines = []
        for f in self.fields:
            v = detection_pred.get(f)
            if v is None or (isinstance(v, float) and np.isnan(v)):
                continue
            lines.append(f"{f.split('_')[-1]}={float(v):.2f}")
        l, t = int(box[0]), int(box[1])
        for i, text in enumerate(lines):
            draw_text(image, text, (l, t + 14 * (i + 1)), scale=0.4,
                      color=(255, 255, 0))


class IgnoreRegionVisualizer(DetectionVisualizer):
    """Shades dataset ignore-region polygons
    (tracklab/visualization ignore-region overlay)."""

    def draw_frame(self, image, detections_pred, detections_gt,
                   image_metadata):
        import cv2
        xs = image_metadata.get("ignore_regions_x")
        ys = image_metadata.get("ignore_regions_y")
        if not xs:
            return
        overlay = image.copy()
        for rx, ry in zip(xs, ys):
            poly = np.stack([np.asarray(rx), np.asarray(ry)],
                            axis=1).astype(np.int32)
            cv2.fillPoly(overlay, [poly], (90, 90, 90))
        cv2.addWeighted(overlay, 0.45, image, 0.55, 0, dst=image)

    def draw_detection(self, image, detection_pred, detection_gt):
        pass
