"""Top-down pose module on host crops: detection rows -> keypoints
(counterpart of tracklab_tpu.wrappers.pose_estimator.topdown_api; the
RTMPose / ViTPose role).

A DetectionLevelModule: the loader threads cut each detection's box out of
its frame (``crop_bbox``) and resize it to the crop size with OpenCV; the
card scales a batch of crops to [0, 1] and runs the pose model's
``predict_keypoints``: ``backbone`` "csp" (``models/pose.py:TopDownPose``,
heatmaps; K3 on its dense CSPLayers), "simcc" (``SimCCPose``) or "vit"
(``models/vitpose.py:ViTPose``). Keypoints come back in image coordinates
(``keypoints_xyc``) with their mean confidence (``keypoints_conf``).

Weights: ``checkpoint_path`` names a ``torch.save``d state dict of the
port's model (``models/convert.py``'s ``*_from_flax`` write one from the
JAX package's tree; for "vit" an HF VitPose state dict has the same keys),
loaded with ``strict=True``, or the JAX package's orbax checkpoint
directory (mapped by the same flax maps); without one the weights are
seeded random.
"""
from __future__ import annotations

import logging

import numpy as np
import pandas as pd
import torch

from tracklab_torch.device import resolve_device
from tracklab_torch.pipeline.levels import DetectionLevelModule
from tracklab_torch.utils.collate import default_collate

log = logging.getLogger(__name__)

__all__ = ["TopDownPoseEstimator", "build_topdown_model"]


def build_topdown_model(owner: str, backbone: str, variant: str,
                        num_keypoints: int, crop_size, checkpoint_path,
                        device):
    """The top-down pose model of ``backbone`` on ``device`` with the
    weights of ``checkpoint_path`` (``models/convert.py:load_checkpoint``),
    else seeded random weights."""
    if backbone == "vit":
        from tracklab_torch.models.vitpose import ViTPose
        model = ViTPose(num_keypoints=num_keypoints, variant=variant,
                        input_size=tuple(crop_size), device="cpu")
    elif backbone == "simcc":
        # the RTMPose-style SimCC codec (models/pose.py:SimCCPose)
        from tracklab_torch.models.pose import SimCCPose
        model = SimCCPose(num_keypoints=num_keypoints, variant=variant,
                          input_size=tuple(crop_size), device="cpu")
    elif backbone == "csp":
        from tracklab_torch.models.pose import TopDownPose
        model = TopDownPose(num_keypoints=num_keypoints, variant=variant,
                            device="cpu")
    else:
        raise ValueError(f"unknown top-down pose backbone {backbone!r}")
    if checkpoint_path:
        from tracklab_torch.models.convert import load_checkpoint
        load_checkpoint(checkpoint_path, model)
    else:
        log.warning("%s: no checkpoint_path given — running with random "
                    "weights", owner)
        model.randomize_(0)
    return model.to(resolve_device(device))


class TopDownPoseEstimator(DetectionLevelModule):
    input_columns = ["bbox_ltwh"]
    output_columns = ["keypoints_xyc", "keypoints_conf"]
    collate_fn = staticmethod(default_collate)

    def __init__(self, variant: str = "s", num_keypoints: int = 17,
                 crop_size=(256, 192), batch_size: int = 32,
                 backbone: str = "csp",
                 checkpoint_path: str | None = None, device=None,
                 **kwargs):
        super().__init__(batch_size)
        self.variant = variant
        self.num_keypoints = num_keypoints
        self.crop_h, self.crop_w = crop_size
        self.backbone = backbone
        self.checkpoint_path = checkpoint_path
        self.device = resolve_device(device)
        self._model = None

    def preprocess(self, image, detection: pd.Series, metadata: pd.Series):
        """Host thread: the detection's crop at the crop size, its origin
        and the crop-to-image scale."""
        import cv2

        from tracklab_torch.utils.cv2 import crop_bbox
        l, t, _, _ = np.asarray(detection["bbox_ltwh"], float)
        crop = crop_bbox(image, detection["bbox_ltwh"])
        ch, cw = crop.shape[:2]
        crop = cv2.resize(crop, (self.crop_w, self.crop_h))
        return {"crop": crop, "origin": np.array([l, t], np.float32),
                "scale": np.array([cw / self.crop_w, ch / self.crop_h],
                                  np.float32)}

    def process(self, batch, detections: pd.DataFrame,
                metadatas: pd.DataFrame):
        if self._model is None:
            self._model = build_topdown_model(
                type(self).__name__, self.backbone, self.variant,
                self.num_keypoints, (self.crop_h, self.crop_w),
                self.checkpoint_path, self.device)
        crops = torch.from_numpy(np.asarray(batch["crop"])).to(self.device)
        kp = self._model.predict_keypoints(crops.float() / 255.0)
        kp = kp.float().cpu().numpy()
        scale, origin = np.asarray(batch["scale"]), np.asarray(
            batch["origin"])
        kp[..., 0] = kp[..., 0] * scale[:, 0:1] + origin[:, 0:1]
        kp[..., 1] = kp[..., 1] * scale[:, 1:2] + origin[:, 1:2]
        result = pd.DataFrame(index=detections.index)
        result["keypoints_xyc"] = list(kp)
        result["keypoints_conf"] = kp[..., 2].mean(axis=1).astype(float)
        return result
