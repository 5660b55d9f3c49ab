"""Keypoint and skeleton visualizer (counterpart of
tracklab_tpu.visualization.keypoints)."""
from __future__ import annotations

import numpy as np

from tracklab_torch.utils.cv2 import draw_keypoints
from tracklab_torch.visualization.visualizer import (
    DetectionVisualizer, track_color,
)

__all__ = ["KeypointsVisualizer"]


class KeypointsVisualizer(DetectionVisualizer):
    def __init__(self, threshold: float = 0.3, draw_skeleton: bool = True,
                 **kwargs):
        self.threshold = threshold
        self.draw_skeleton = draw_skeleton

    def draw_detection(self, image, detection_pred, detection_gt):
        if detection_pred is None:
            return
        kp = detection_pred.get("keypoints_xyc")
        if kp is None or (isinstance(kp, float) and np.isnan(kp)):
            return
        tid = detection_pred.get("track_id")
        color = track_color(None if tid is None
                            or (isinstance(tid, float) and np.isnan(tid))
                            else int(tid))
        draw_keypoints(image, np.asarray(kp), color=color,
                       threshold=self.threshold,
                       skeleton=self.draw_skeleton)
