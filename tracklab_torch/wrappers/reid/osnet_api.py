"""ReID module on host crops: detection rows -> OSNet appearance embeddings
(counterpart of tracklab_tpu.wrappers.reid.osnet_api).

A DetectionLevelModule: the loader threads cut each detection's box out of
its frame (:func:`crop_bbox`) and resize it to the crop size with OpenCV's
bilinear resize, as the JAX package does; the card normalises a batch of
crops and runs ``models/osnet.py:OSNet``. The output columns are
``embeddings`` (the part layout (n_parts + 1, feat_dim) with
``use_parts``, row 0 the global feature; else the global feature) and
``visibility_scores``.

With ``use_keypoints`` (BASELINE config 3) each crop also carries one
gaussian prompt channel per keypoint group (``KP_GROUPS``: head, torso,
arms, legs, feet; ``reid_dataset.py:gaussian_keypoint_masks`` of the row's
``keypoints_xyc``, the max over the group), so OSNet's stem takes 3 + 5 = 8
channels, and the visibility of stripe parts 1..5 is the group's largest
keypoint confidence (the KPR prompt mechanism).

Weights: ``checkpoint_path`` names a ``torch.save``d state dict, either the
port's (``models/convert.py:osnet_from_flax`` builds the model from the
JAX package's tree) or a torchreid OSNet's (loaded through
``convert_osnet_torch``); without one the weights are seeded random
(``OSNet.randomize_(0)``).
"""
from __future__ import annotations

import logging

import numpy as np
import pandas as pd
import torch

from tracklab_torch.device import resolve_device
from tracklab_torch.models.preprocess import IMAGENET_MEAN, IMAGENET_STD
from tracklab_torch.pipeline.levels import DetectionLevelModule
from tracklab_torch.utils.collate import default_collate

log = logging.getLogger(__name__)

__all__ = ["OSNetReId", "build_osnet"]

_NOT_PORTED = "{} is not ported to tracklab_torch yet (ROADMAP item {})"


def build_osnet(owner: str, variant: str, feat_dim: int, n_parts: int,
                ibn: bool, checkpoint_path, device, in_channels: int = 3):
    """An ``OSNet`` on ``device`` with the weights of ``checkpoint_path``
    (the port's state dict, loaded strict, or a torchreid state dict, whose
    part head keeps seeded weights), else seeded random weights."""
    from tracklab_torch.models.convert import convert_osnet_torch
    from tracklab_torch.models.osnet import OSNet

    model = OSNet(variant, feat_dim, n_parts, ibn=ibn,
                  in_channels=in_channels, device="cpu")
    model.randomize_(0)
    if checkpoint_path:
        state = torch.load(checkpoint_path, map_location="cpu",
                           weights_only=True)
        state = state.get("state_dict", state)
        if set(state) == set(model.state_dict()):
            model.load_state_dict(state, strict=True)
        else:
            convert_osnet_torch(state, model)
    else:
        log.warning("%s: no checkpoint_path given — running with random "
                    "weights", owner)
    return model.to(resolve_device(device))


class OSNetReId(DetectionLevelModule):
    input_columns = ["bbox_ltwh"]
    output_columns = ["embeddings", "visibility_scores"]
    training_enabled = True
    collate_fn = staticmethod(default_collate)

    # COCO-17 keypoint groups -> body parts (KPR's part structure): head,
    # torso, arms, legs, feet
    KP_GROUPS = [[0, 1, 2, 3, 4], [5, 6, 11, 12], [7, 8, 9, 10], [13, 14],
                 [15, 16]]

    def __init__(self, variant: str = "x1_0", feat_dim: int = 512,
                 n_parts: int = 6, crop_size=(256, 128),
                 batch_size: int = 32, use_parts: bool = True,
                 use_keypoints: bool = False, ibn: bool = False,
                 checkpoint_path: str | None = None, device=None,
                 backbone: str = "osnet", **kwargs):
        super().__init__(batch_size)
        if backbone != "osnet":
            raise NotImplementedError(_NOT_PORTED.format(
                f"the ReID backbone {backbone!r}", "4: the model zoo"))
        self.variant = variant
        self.feat_dim = feat_dim
        self.n_parts = n_parts
        self.crop_h, self.crop_w = crop_size
        self.use_parts = use_parts
        self.use_keypoints = use_keypoints
        self.ibn = ibn
        self.checkpoint_path = checkpoint_path
        self.device = resolve_device(device)
        self._model = None
        self._consts = None
        if use_keypoints:
            self.input_columns = ["bbox_ltwh", "keypoints_xyc"]

    def _build(self):
        in_channels = 3 + (len(self.KP_GROUPS) if self.use_keypoints else 0)
        self._model = build_osnet(type(self).__name__, self.variant,
                                  self.feat_dim, self.n_parts, self.ibn,
                                  self.checkpoint_path, self.device,
                                  in_channels)
        self._consts = tuple(torch.tensor(c, dtype=torch.float32,
                                          device=self.device)
                             for c in (IMAGENET_MEAN, IMAGENET_STD))

    def preprocess(self, image, detection: pd.Series, metadata: pd.Series):
        """Host thread: the detection's crop, resized with OpenCV; with
        ``use_keypoints`` its prompt channels appended and each group's
        keypoint visibility (``kp_vis``)."""
        import cv2

        from tracklab_torch.utils.cv2 import crop_bbox
        crop = crop_bbox(image, detection["bbox_ltwh"])
        crop = cv2.resize(crop, (self.crop_w, self.crop_h),
                          interpolation=cv2.INTER_LINEAR).astype(np.float32)
        if not self.use_keypoints:
            return {"crop": crop}
        from tracklab_torch.wrappers.reid.reid_dataset import (
            gaussian_keypoint_masks)
        kp = detection.get("keypoints_xyc")
        G = len(self.KP_GROUPS)
        prompts = np.zeros((self.crop_h, self.crop_w, G), np.float32)
        kp_vis = np.zeros(G, np.float32)
        if isinstance(kp, np.ndarray):
            masks = gaussian_keypoint_masks(kp, (self.crop_h, self.crop_w),
                                            detection["bbox_ltwh"])
            for g, idxs in enumerate(self.KP_GROUPS):
                idxs = [i for i in idxs if i < len(kp)]
                if idxs:
                    prompts[..., g] = masks[idxs].max(axis=0)
                    kp_vis[g] = float(np.max(kp[idxs, 2]))
        return {"crop": np.concatenate([crop, prompts], axis=-1),
                "kp_vis": kp_vis}

    def process(self, batch, detections: pd.DataFrame,
                metadatas: pd.DataFrame):
        if self._model is None:
            self._build()
        mean, std = self._consts
        crops = torch.from_numpy(np.asarray(batch["crop"])).to(self.device)
        x = (crops[..., :3] - mean) / std
        if crops.shape[-1] > 3:                     # the prompt channels
            x = torch.cat([x, crops[..., 3:]], dim=-1)
        out = self._model(x)
        result = pd.DataFrame(index=detections.index)
        if self.use_parts:
            vis = out["visibility"].cpu().numpy()
            if self.use_keypoints and "kp_vis" in batch:
                # keypoint visibility for stripe parts 1..G (the global part
                # stays 1; stripes past the groups keep their mass)
                kv = np.asarray(batch["kp_vis"], np.float32)
                g = min(kv.shape[1], vis.shape[1] - 1)
                vis = vis.copy()
                vis[:, 1:1 + g] = kv[:, :g]
            result["embeddings"] = list(out["part_features"].cpu().numpy())
            result["visibility_scores"] = list(vis)
        else:
            result["embeddings"] = list(out["embeddings"].cpu().numpy())
            result["visibility_scores"] = [
                np.ones(1, np.float32)] * len(detections)
        return result

    def train(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format(
            "OSNetReId.train", "6: training"))
