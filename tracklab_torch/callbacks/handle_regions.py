"""Flag detections inside a dataset's ignore regions (counterpart of
tracklab_tpu.callbacks.handle_regions).

At the end of a video, its ignore-region polygons are rasterised
(``cv2.fillPoly``) and each detection gets ``in_ignored_region``: whether
the share of its box inside the regions exceeds ``max_intersection``.
"""
from __future__ import annotations

import numpy as np

from tracklab_torch.callbacks.callback import Callback

__all__ = ["IgnoredRegions"]


class IgnoredRegions(Callback):
    after_saved_state = False

    def __init__(self, max_intersection: float = 0.9, **kwargs):
        self.max_intersection = max_intersection

    def on_video_loop_end(self, engine, video_metadata, video_idx,
                          detections, image_pred):
        if detections is None or len(detections) == 0:
            return
        if video_metadata.get("ignore_regions_x") is None:
            return
        import cv2
        w = int(video_metadata.get("im_width", 1920))
        h = int(video_metadata.get("im_height", 1080))
        mask = np.zeros((h, w), np.uint8)
        for rx, ry in zip(video_metadata["ignore_regions_x"],
                          video_metadata["ignore_regions_y"]):
            poly = np.stack([np.asarray(rx), np.asarray(ry)],
                            axis=1).astype(np.int32)
            cv2.fillPoly(mask, [poly], 1)
        flags = []
        for box in detections["bbox_ltwh"]:
            l, t, bw, bh = np.asarray(box, float)
            x1, y1 = max(int(l), 0), max(int(t), 0)
            x2, y2 = min(int(l + bw), w), min(int(t + bh), h)
            area = max(x2 - x1, 0) * max(y2 - y1, 0)
            flags.append(bool(area) and mask[y1:y2, x1:x2].sum() / area
                         > self.max_intersection)
        detections["in_ignored_region"] = flags
