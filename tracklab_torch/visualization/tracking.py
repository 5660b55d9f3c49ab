"""Track-history visualizer: each track's recent foot-point trail
(counterpart of tracklab_tpu.visualization.tracking)."""
from __future__ import annotations

from collections import defaultdict, deque

import numpy as np

from tracklab_torch.visualization.visualizer import (
    DetectionVisualizer, track_color,
)

__all__ = ["TrackingLineVisualizer"]


class TrackingLineVisualizer(DetectionVisualizer):
    def __init__(self, history: int = 30, **kwargs):
        self.history = history
        self._trails = defaultdict(lambda: deque(maxlen=history))
        self._last_video = None

    def reset(self):
        self._trails.clear()

    def draw_detection(self, image, detection_pred, detection_gt):
        import cv2
        if detection_pred is None:
            return
        tid = detection_pred.get("track_id")
        if tid is None or (isinstance(tid, float) and np.isnan(tid)):
            return
        tid = int(tid)
        box = detection_pred.get("track_bbox_ltwh",
                                 detection_pred.get("bbox_ltwh"))
        if box is None:
            return
        l, t, w, h = [float(v) for v in box]
        self._trails[tid].append((int(l + w / 2), int(t + h)))
        pts = list(self._trails[tid])
        color = track_color(tid)
        for a, b in zip(pts, pts[1:]):
            cv2.line(image, a, b, color, 2, cv2.LINE_AA)
