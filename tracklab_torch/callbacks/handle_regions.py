"""Flag detections inside a dataset's ignore regions (counterpart of
tracklab_tpu.callbacks.handle_regions).

At the end of a video, its ignore-region polygons are rasterised
(``cv2.fillPoly``) and each detection gets ``in_ignored_region``: whether
the share of its box inside the regions exceeds ``max_intersection``. The
regions are the video row's ``ignore_regions_x``/``ignore_regions_y`` when
it has them, else each image row's own (PoseTrack marks them per frame;
the JAX callback reads the video row's only).
"""
from __future__ import annotations

import numpy as np

from tracklab_torch.callbacks.callback import Callback

__all__ = ["IgnoredRegions"]


def _region_mask(xs, ys, h, w):
    """(h, w) uint8 mask of the polygons (``xs[i]``, ``ys[i]``)."""
    import cv2
    mask = np.zeros((h, w), np.uint8)
    for rx, ry in zip(xs, ys):
        poly = np.stack([np.asarray(rx), np.asarray(ry)],
                        axis=1).astype(np.int32)
        if len(poly):
            cv2.fillPoly(mask, [poly], 1)
    return mask


class IgnoredRegions(Callback):
    after_saved_state = False

    def __init__(self, max_intersection: float = 0.9, **kwargs):
        self.max_intersection = max_intersection

    def _inside(self, mask, box):
        h, w = mask.shape
        l, t, bw, bh = np.asarray(box, float)
        x1, y1 = max(int(l), 0), max(int(t), 0)
        x2, y2 = min(int(l + bw), w), min(int(t + bh), h)
        area = max(x2 - x1, 0) * max(y2 - y1, 0)
        return bool(area) and mask[y1:y2, x1:x2].sum() / area \
            > self.max_intersection

    def on_video_loop_end(self, engine, video_metadata, video_idx,
                          detections, image_pred):
        if detections is None or len(detections) == 0:
            return
        w = int(video_metadata.get("im_width", 1920))
        h = int(video_metadata.get("im_height", 1080))

        def mask(row):
            xs = None if row is None else row["ignore_regions_x"]
            if not isinstance(xs, (list, tuple, np.ndarray)) or not len(xs):
                return None
            return _region_mask(xs, row["ignore_regions_y"], h, w)

        if video_metadata.get("ignore_regions_x") is not None:
            # the video row's regions hold for every image
            masks = [mask(video_metadata)] * len(detections)
        elif image_pred is not None and "ignore_regions_x" in image_pred:
            ids = detections["image_id"]
            by_image = {i: mask(image_pred.loc[i] if i in image_pred.index
                                else None) for i in ids.unique()}
            masks = [by_image[i] for i in ids]
        else:
            return
        detections["in_ignored_region"] = [
            m is not None and self._inside(m, box)
            for m, box in zip(masks, detections["bbox_ltwh"])]
