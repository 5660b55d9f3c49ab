"""Batched top-down pose on the card: every detection of a batch of frames
in one forward (counterpart of
tracklab_tpu.wrappers.pose_estimator.batched_api).

An ImageLevelModule: the loader threads resize each frame to the work size
with OpenCV and pad its boxes (in work coordinates) to ``max_dets`` slots;
the card crops every slot (``models/preprocess.py:crop_resize``) and runs
the pose model over the batch (``engine/fused.py:make_topdown_pose_fn``);
keypoints come back in image coordinates. The engine's fused path can run
this module between a fused detector and a detections-only tracker in one
device program (``engine/fused.py:run_fused_pose_video``); its crops then
come from the detector's letterboxed frames, which are this module's work
image when the work size equals the detector's input and the frame size.

Weights: ``checkpoint_path`` as ``TopDownPoseEstimator``'s
(``topdown_api.build_topdown_model``): the port's state dict or the JAX
package's orbax checkpoint directory.
"""
from __future__ import annotations

import logging

import numpy as np
import pandas as pd
import torch

from tracklab_torch.device import resolve_device
from tracklab_torch.pipeline.levels import ImageLevelModule
from tracklab_torch.utils.collate import default_collate
from tracklab_torch.wrappers.pose_estimator.topdown_api import \
    build_topdown_model

log = logging.getLogger(__name__)

__all__ = ["TopDownPoseBatched"]


class TopDownPoseBatched(ImageLevelModule):
    input_columns = ["bbox_ltwh"]
    output_columns = ["keypoints_xyc", "keypoints_conf"]
    collate_fn = staticmethod(default_collate)
    # the engine's fused path can put this module between a fused detector
    # and a tracker (engine/fused.py:run_fused_pose_video)
    supports_fused_pose = True

    def __init__(self, variant: str = "s", num_keypoints: int = 17,
                 crop_size=(256, 192), work_size=(736, 1280),
                 max_dets: int = 32, batch_size: int = 4,
                 backbone: str = "csp", checkpoint_path: str | None = None,
                 device=None, **kwargs):
        super().__init__(batch_size)
        self.variant = variant
        self.num_keypoints = num_keypoints
        self.crop_h, self.crop_w = crop_size
        self.work_h, self.work_w = work_size
        self.max_dets = max_dets
        self.backbone = backbone
        self.checkpoint_path = checkpoint_path
        self.device = resolve_device(device)
        self._model = None
        self._pose = None

    def device_pose_fn(self):
        """``(frames, boxes) -> keypoints (B, D, K, 3)`` on the card, in the
        frames' coordinates: device crops + pose, the same math as
        ``process`` (for the fused path the frames are the detector's)."""
        from tracklab_torch.engine.fused import make_topdown_pose_fn
        if self._model is None:
            self._model = build_topdown_model(
                type(self).__name__, self.backbone, self.variant,
                self.num_keypoints, (self.crop_h, self.crop_w),
                self.checkpoint_path, self.device)
        return make_topdown_pose_fn(self._model,
                                    crop_size=(self.crop_h, self.crop_w),
                                    num_keypoints=self.num_keypoints)

    def preprocess(self, image, detections: pd.DataFrame,
                   metadata: pd.Series):
        """Host thread: the work image and the frame's boxes in work
        coordinates, padded to ``max_dets`` (row id -1 on empty slots), and
        the work-to-image scale."""
        import cv2
        h0, w0 = image.shape[:2]
        work = cv2.resize(image, (self.work_w, self.work_h))
        sx, sy = self.work_w / w0, self.work_h / h0
        boxes = np.zeros((self.max_dets, 4), np.float32)
        rows = np.full(self.max_dets, -1, np.int64)
        n = min(len(detections), self.max_dets)
        if n:
            ltwh = np.stack(detections["bbox_ltwh"].to_numpy()[:n])
            boxes[:n, 0] = ltwh[:, 0] * sx
            boxes[:n, 1] = ltwh[:, 1] * sy
            boxes[:n, 2] = (ltwh[:, 0] + ltwh[:, 2]) * sx
            boxes[:n, 3] = (ltwh[:, 1] + ltwh[:, 3]) * sy
            rows[:n] = detections.index.to_numpy()[:n]
        return {"image": work, "boxes": boxes, "rows": rows,
                "scale": np.array([1.0 / sx, 1.0 / sy], np.float32)}

    def process(self, batch, detections: pd.DataFrame,
                metadatas: pd.DataFrame):
        from tracklab_torch.engine.fused import _pose_rows
        if self._pose is None:
            self._pose = self.device_pose_fn()
        # a short last batch is padded to batch_size with empty frames, so
        # every frame goes through one batch shape
        images, boxes = batch["image"], batch["boxes"]
        n = len(images)
        if n < self.batch_size:
            pad = self.batch_size - n
            images = np.concatenate([images, np.zeros(
                (pad,) + images.shape[1:], images.dtype)])
            boxes = np.concatenate([boxes, np.zeros(
                (pad,) + boxes.shape[1:], boxes.dtype)])
        kp = self._pose(torch.from_numpy(images).to(self.device),
                        torch.from_numpy(boxes).to(self.device))
        kp = kp[:n].cpu().numpy()
        scale = np.asarray(batch["scale"], np.float32)
        kp[..., 0] *= scale[:, None, None, 0]     # work -> image coordinates
        kp[..., 1] *= scale[:, None, None, 1]
        rows = np.asarray(batch["rows"])
        return _pose_rows(kp, rows >= 0, rows.reshape(-1))
