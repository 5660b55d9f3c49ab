"""Bottom-up pose module: full image -> boxes + keypoints in one pass
(counterpart of tracklab_tpu.wrappers.pose_estimator.bottomup_api; the RTMO
role, so it can head a pipeline without a separate detector).

Host threads letterbox each frame (``letterbox``, 114 grey); the card runs
YOLOXPose (``models/pose.py``; K3 on its dense CSPLayers) or YOLO11-Pose
(``variant: "11m"`` etc.), NMS and the nearest-centre anchor match of each
detection's keypoints (``engine/fused.py:make_bottomup_detect_fn``); the
host maps the keypoints back to the frame and regenerates each box from
them (``utils/coordinates.py:generate_bbox_from_keypoints``). The engine's
fused path can run this module and a detections-only tracker as one device
program (``engine/fused.py:run_fused_bottomup_video``).

Weights: ``checkpoint_path`` names a ``torch.save``d state dict of the
port's model (``models/convert.py:yoloxpose_from_flax`` /
``yolo11_from_flax`` write one from the JAX package's tree; an ultralytics
pose state dict loads into YOLO11-Pose through ``convert_yolov8_torch``);
without one the weights are seeded random (``randomize_(0)``).
"""
from __future__ import annotations

import logging

import numpy as np
import pandas as pd
import torch

from tracklab_torch.device import resolve_device
from tracklab_torch.pipeline.levels import ImageLevelModule
from tracklab_torch.utils import coordinates as C
from tracklab_torch.utils.collate import default_collate
from tracklab_torch.wrappers.bbox_detector.yolox_api import letterbox

log = logging.getLogger(__name__)

__all__ = ["BottomUpPoseEstimator"]


class BottomUpPoseEstimator(ImageLevelModule):
    input_columns = []
    output_columns = ["image_id", "video_id", "category_id", "bbox_ltwh",
                      "bbox_conf", "keypoints_xyc", "keypoints_conf"]
    collate_fn = staticmethod(default_collate)
    # the engine's fused path can run this pose head with a tracker as one
    # device program (engine/fused.py:run_fused_bottomup_video)
    supports_fused_bottomup = True

    def __init__(self, variant: str = "s", num_keypoints: int = 17,
                 input_size=(640, 640), min_confidence: float = 0.4,
                 nms_iou: float = 0.65, max_dets: int = 64,
                 batch_size: int = 8,
                 bbox_extension_factor=(0.05, 0.05, 0.05),
                 checkpoint_path: str | None = None, device=None,
                 **kwargs):
        super().__init__(batch_size)
        self.variant = variant
        self.num_keypoints = num_keypoints
        self.input_size = tuple(input_size)
        self.min_confidence = min_confidence
        self.nms_iou = nms_iou
        self.max_dets = max_dets
        self.bbox_ext = tuple(bbox_extension_factor)
        self.checkpoint_path = checkpoint_path
        self.device = resolve_device(device)
        self._model = None
        self._detect = None
        self.id = 0  # global detection row id

    @property
    def _yolo11(self):
        return self.variant.startswith("11")

    def _build(self):
        if self._yolo11:
            # ultralytics YOLO11-pose (the reference's bottom-up default:
            # yolo_ultralytics-pose.yaml -> yolo11m-pose.pt)
            from tracklab_torch.models.yolo11 import YOLO11Pose
            model = YOLO11Pose(num_classes=1,
                               num_keypoints=self.num_keypoints,
                               variant=self.variant[2:], device=self.device)
        else:
            from tracklab_torch.models.pose import YOLOXPose
            model = YOLOXPose(num_classes=1,
                              num_keypoints=self.num_keypoints,
                              variant=self.variant, device=self.device)
        if self.checkpoint_path:
            from tracklab_torch.models.convert import load_checkpoint
            load_checkpoint(self.checkpoint_path, model)
        else:
            log.warning("BottomUpPoseEstimator: no checkpoint_path given — "
                        "running with random weights")
            model.randomize_(0)
        self._model = model
        self._detect = self.device_detect_fn()

    def device_detect_fn(self):
        """``(frames, meta) -> (Detections, keypoints)`` on the card for the
        fused path, the same math as ``process`` (keypoints to original
        coordinates and boxes from keypoints on the device)."""
        from tracklab_torch.engine.fused import make_bottomup_detect_fn
        if self._model is None:
            self._build()
        model = self._model
        if self._yolo11:
            def predict(images):
                return model.predict(images / 255.0)
        else:
            predict = model.predict
        return make_bottomup_detect_fn(
            predict, conf_threshold=self.min_confidence,
            iou_threshold=self.nms_iou, max_dets=self.max_dets,
            bbox_extension_factor=self.bbox_ext)

    def preprocess(self, image, detections, metadata):
        """Host thread: letterbox the decoded RGB frame (no CUDA work)."""
        return letterbox(image, self.input_size)

    def process(self, batch, detections, metadatas: pd.DataFrame):
        if self._model is None:
            self._build()
        # a short last batch is padded to batch_size with zero frames, as
        # the fused path pads its last chunk (one batch shape on both paths)
        images = batch["image"]
        n = len(images)
        if n < self.batch_size:
            images = np.concatenate([images, np.zeros(
                (self.batch_size - n,) + images.shape[1:], images.dtype)])
        dets, kps = self._detect(torch.from_numpy(images).to(self.device))
        valid, score, kps = (x[:n].cpu().numpy() for x in
                             (dets.valid, dets.conf, kps))
        fs, ds = np.nonzero(valid)
        # letterbox -> frame coordinates, then the box around the keypoints
        kp = kps[fs, ds].copy()
        scale = np.asarray(batch["scale"], np.float32)[fs][:, None]
        pad = np.asarray(batch["pad"], np.float32)[fs][:, None, :]
        kp[..., 0:2] = (kp[..., 0:2] - pad) / scale[..., None]
        shape = np.asarray(batch["shape"], np.float32)[fs]
        ltwh = np.stack([C.generate_bbox_from_keypoints(
            k, self.bbox_ext, (w0, h0)) for k, (w0, h0) in zip(kp, shape)]) \
            if len(fs) else np.zeros((0, 4))
        return self._rows(metadatas, fs, ltwh, score[fs, ds], kp)

    def _rows(self, metadatas, fs, ltwh, score, kp):
        """Detection rows of frames ``metadatas.index[fs]`` (boxes ltwh,
        scores, keypoints (N, K, 3) in frame coordinates), numbered from the
        module's running row id."""
        ids = self.id + np.arange(len(fs))
        self.id += len(fs)
        kp = np.asarray(kp, np.float32)
        return pd.DataFrame({
            "image_id": metadatas.index.to_numpy()[fs],
            "video_id": metadatas["video_id"].to_numpy()[fs],
            "category_id": np.ones(len(fs), np.int64),
            "bbox_ltwh": list(np.asarray(ltwh, np.float32)),
            "bbox_conf": np.asarray(score, np.float64),
            "keypoints_xyc": list(kp),
            "keypoints_conf": kp[..., 2].mean(axis=1).astype(np.float64),
        }, index=ids)
