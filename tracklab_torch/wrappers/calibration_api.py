"""Calibration pipeline modules (counterpart of
tracklab_tpu.wrappers.calibration_api).

- :class:`PitchLineDetector`, image level: the pitch-line segmenter
  (``models/segmentation.py``) and the per-line point picking run on the
  card in one pass per batch and emit the ``pitch_lines`` image column
  (segment name -> (N, 2) pixel points).
- :class:`TVCalibration`, image level: per-frame camera parameters by
  gradient descent on the card (``calibration/tvcalib.py``) against the
  ``pitch_lines`` column, or passed through from dataset-provided
  parameters; emits the ``parameters`` image column.
- :class:`PitchProjection`, video level: back-projects each detection's
  bbox bottom edge onto the pitch plane with its frame's camera, all frames
  of a video in one batch on the card, and emits the ``bbox_pitch``
  detection column.
"""
from __future__ import annotations

import logging

import numpy as np
import pandas as pd
import torch

from tracklab_torch.device import resolve_device
from tracklab_torch.pipeline.levels import ImageLevelModule, VideoLevelModule
from tracklab_torch.utils.collate import Unbatchable, default_collate

log = logging.getLogger(__name__)

__all__ = ["PitchLineDetector", "TVCalibration", "PitchProjection"]


class PitchLineDetector(ImageLevelModule):
    """Pitch-line segmentation front-end. ``variant`` is a YOLOX backbone
    width ("nano" .. "x") of the port's ``PitchSegNet``, or "deeplabv3",
    the reference's DeepLabV3-ResNet101 (``models/deeplabv3.py``: ImageNet
    mean and std on 0-255 pixels, argmax, then a LUT gather from its 29
    line classes onto the port's segments). ``checkpoint_path`` names a
    state dict: the port's ``PitchSegNet`` (``models/convert.py:
    pitchsegnet_from_flax`` writes one from the JAX package's tree), loaded
    with ``strict=True``, or a torchvision DeepLabV3 (the SoccerNet
    checkpoint, or ``deeplabv3_from_flax``'s), through
    ``convert_deeplabv3_torch``; without one the weights are seeded random,
    with a warning."""

    input_columns = {"image": [], "detection": []}
    output_columns = {"image": ["pitch_lines"], "detection": []}
    collate_fn = staticmethod(default_collate)

    def __init__(self, variant: str = "s", input_size=(288, 512),
                 points_per_line: int = 32,
                 checkpoint_path: str | None = None,
                 batch_size: int = 8, device=None, **kwargs):
        super().__init__(batch_size)
        from tracklab_torch.calibration.pitch import pitch_segments
        self.segment_names = list(pitch_segments())
        self.num_classes = len(self.segment_names) + 1
        self.variant = variant
        self.input_size = tuple(input_size)
        self.points_per_line = points_per_line
        self.checkpoint_path = checkpoint_path
        self.device = resolve_device(device)
        self._model = None

    def _build(self):
        if self.variant == "deeplabv3":
            from tracklab_torch.models.deeplabv3 import (DeepLabV3,
                                                         segment_class_lut)
            model = DeepLabV3(device=self.device)
            lut = segment_class_lut(self.segment_names, self.device)
            mean = torch.tensor([0.485, 0.456, 0.406],
                                device=self.device) * 255.0
            std = torch.tensor([0.229, 0.224, 0.225],
                               device=self.device) * 255.0
            self._class_map = lambda images: lut[model.predict(
                (images.float() - mean) / std)]
        else:
            from tracklab_torch.models.segmentation import PitchSegNet
            model = PitchSegNet(self.num_classes, self.variant,
                                device=self.device)
            self._class_map = model.predict
        if self.checkpoint_path:
            from tracklab_torch.models.convert import load_checkpoint
            load_checkpoint(self.checkpoint_path, model)
        else:
            log.warning("PitchLineDetector: no checkpoint_path given — "
                        "running with random weights")
            model.randomize_(0)
        self._model = model

    def infer(self, images):
        """(B, h, w, 3) images at ``input_size`` on the card -> (xy
        (B, C-1, n, 2), valid (B, C-1, n)) in input pixels."""
        from tracklab_torch.models.segmentation import extract_segment_points
        if self._model is None:
            self._build()
        cmap = self._class_map(images)
        return extract_segment_points(cmap, self.num_classes,
                                      self.points_per_line)

    def preprocess(self, image, detections, metadata):
        """Host thread: resize to ``input_size`` (bilinear, half-pixel
        centres, as cv2.INTER_LINEAR samples)."""
        from tracklab_torch.wrappers.bbox_detector.yolox_api import \
            _resize_bilinear
        h, w = self.input_size
        h0, w0 = image.shape[:2]
        return {"image": _resize_bilinear(image, h, w),
                "scale": np.array([w0 / w, h0 / h], np.float32)}

    def process(self, batch, detections, metadatas: pd.DataFrame):
        images = torch.as_tensor(np.asarray(batch["image"])).to(self.device)
        xy, valid = (t.cpu().numpy() for t in self.infer(images))
        rows = []
        for i, image_id in enumerate(metadatas.index):
            scale = np.asarray(batch["scale"][i])
            lines = {}
            for c, name in enumerate(self.segment_names):
                pts = xy[i, c][valid[i, c]] * scale
                if len(pts):
                    lines[name] = pts.astype(np.float32)
            rows.append(pd.Series({"pitch_lines": lines}, name=image_id))
        return [], rows


class TVCalibration(ImageLevelModule):
    input_columns = {"image": [], "detection": []}
    output_columns = {"image": ["parameters"], "detection": []}
    collate_fn = staticmethod(default_collate)

    def __init__(self, steps: int = 300, lr: float = 0.05,
                 image_width: int = 1920, image_height: int = 1080,
                 batch_size: int = 16, device=None, **kwargs):
        super().__init__(batch_size)
        from tracklab_torch.calibration.tvcalib import TVCalibConfig
        self.cfg = TVCalibConfig(steps=steps, lr=lr,
                                 image_width=image_width,
                                 image_height=image_height)
        self.device = resolve_device(device)

    def preprocess(self, image, detections, metadata):
        return {"pitch_lines": Unbatchable(
            _dict_or_empty(metadata.get("pitch_lines")))}

    def process(self, batch, detections, metadatas: pd.DataFrame):
        from tracklab_torch.calibration.tvcalib import optimize_cameras
        observations = batch["pitch_lines"]
        have_obs = [bool(o) for o in observations]
        cams = err = None
        if any(have_obs):
            cams, err = optimize_cameras(list(observations), self.cfg,
                                         device=self.device)
        rows = []
        for i, (image_id, md) in enumerate(metadatas.iterrows()):
            if have_obs[i]:
                cam = dict(cams[i])
                cam.pop("latent", None)
                cam["relative_mean_reproj"] = float(err[i])
                rows.append(pd.Series({"parameters": cam}, name=image_id))
            elif isinstance(md.get("parameters"), dict):
                # no pitch lines for this frame: pass the dataset's camera
                # through instead of the prior mean of an empty descent
                rows.append(pd.Series({"parameters": md["parameters"]},
                                      name=image_id))
        return [], rows


def _dict_or_empty(v):
    return v if isinstance(v, dict) else {}


class PitchProjection(VideoLevelModule):
    input_columns = {"detection": ["bbox_ltwh"], "image": ["parameters"]}
    output_columns = {"detection": ["bbox_pitch"], "image": []}

    def __init__(self, image_width: int = 1920, image_height: int = 1080,
                 device=None, **kwargs):
        self.image_width = image_width
        self.image_height = image_height
        self.device = resolve_device(device)

    @staticmethod
    def _camera_values(p, width, height):
        """A parameters dict -> [pan, tilt, roll (radians), focal,
        x, y, z, cx, cy], with the JAX module's defaults for absent keys."""
        pp = p.get("principal_point", [width / 2, height / 2])
        pos = p.get("position_meters", [0.0, 45.0, 15.0])
        return [np.deg2rad(np.float32(p.get("pan_degrees", 0.0))),
                np.deg2rad(np.float32(p.get("tilt_degrees", 70.0))),
                np.deg2rad(np.float32(p.get("roll_degrees", 0.0))),
                p.get("x_focal_length", 2500.0)] \
            + [float(v) for v in pos] + [float(v) for v in pp]

    def process(self, detections: pd.DataFrame,
                metadatas: pd.DataFrame) -> pd.DataFrame:
        from tracklab_torch.calibration.camera import (CameraParams,
                                                       backproject_to_pitch)
        if len(detections) == 0 or "parameters" not in metadatas.columns:
            return pd.DataFrame(index=detections.index,
                                columns=["bbox_pitch"])
        cams, groups = [], []
        for image_id, params in metadatas["parameters"].items():
            dets = detections[detections["image_id"] == image_id]
            if not isinstance(params, dict) or len(dets) == 0:
                continue
            cams.append(self._camera_values(params, self.image_width,
                                            self.image_height))
            groups.append(dets)
        if not cams:
            return pd.DataFrame(index=[], columns=["bbox_pitch"])
        # every frame's bottom-left, bottom-right and bottom-middle points,
        # padded to one width, back-projected in one batch
        n_max = max(len(g) for g in groups)
        pix = np.zeros((len(groups), 3 * n_max, 2), np.float32)
        for f, dets in enumerate(groups):
            b = np.stack(dets["bbox_ltwh"].to_numpy()).astype(float)
            n = len(b)
            bl = np.stack([b[:, 0], b[:, 1] + b[:, 3]], 1)
            br = np.stack([b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]], 1)
            pix[f, :3 * n] = np.concatenate([bl, br, (bl + br) / 2])
        c = torch.as_tensor(np.asarray(cams, np.float32), device=self.device)
        cam = CameraParams(pan=c[:, 0], tilt=c[:, 1], roll=c[:, 2],
                           focal=c[:, 3], position=c[:, 4:7],
                           principal=c[:, 7:9])
        world = backproject_to_pitch(
            cam, torch.as_tensor(pix, device=self.device)).cpu().numpy()
        out = {}
        for f, dets in enumerate(groups):
            n = len(dets)
            for i, idx in enumerate(dets.index):
                out[idx] = {
                    "x_bottom_left": float(world[f, i, 0]),
                    "y_bottom_left": float(world[f, i, 1]),
                    "x_bottom_right": float(world[f, n + i, 0]),
                    "y_bottom_right": float(world[f, n + i, 1]),
                    "x_bottom_middle": float(world[f, 2 * n + i, 0]),
                    "y_bottom_middle": float(world[f, 2 * n + i, 1]),
                }
        result = pd.DataFrame(index=list(out.keys()))
        result["bbox_pitch"] = list(out.values())
        return result
