"""ReID module on host crops: detection rows -> OSNet appearance embeddings
(counterpart of tracklab_tpu.wrappers.reid.osnet_api).

A DetectionLevelModule: the loader threads cut each detection's box out of
its frame (:func:`crop_bbox`) and resize it to the crop size with OpenCV's
bilinear resize, as the JAX package does; the card normalises a batch of
crops and runs ``models/osnet.py:OSNet``. The output columns are
``embeddings`` (the part layout (n_parts + 1, feat_dim) with
``use_parts``, row 0 the global feature; else the global feature) and
``visibility_scores``.

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
                ibn: bool, checkpoint_path, device):
    """An ``OSNet`` on ``device`` with the weights of ``checkpoint_path``
    (the port's state dict, loaded strict, or a torchreid state dict, whose
    part head keeps seeded weights), else seeded random weights."""
    from tracklab_torch.models.convert import convert_osnet_torch
    from tracklab_torch.models.osnet import OSNet

    model = OSNet(variant, feat_dim, n_parts, ibn=ibn, device="cpu")
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

    def __init__(self, variant: str = "x1_0", feat_dim: int = 512,
                 n_parts: int = 6, crop_size=(256, 128),
                 batch_size: int = 32, use_parts: bool = True,
                 use_keypoints: bool = False, ibn: bool = False,
                 checkpoint_path: str | None = None, device=None,
                 backbone: str = "osnet", **kwargs):
        super().__init__(batch_size)
        if use_keypoints:
            raise NotImplementedError(_NOT_PORTED.format(
                "OSNetReId(use_keypoints=True)", "3: pose"))
        if backbone != "osnet":
            raise NotImplementedError(_NOT_PORTED.format(
                f"the ReID backbone {backbone!r}", "4: the model zoo"))
        self.variant = variant
        self.feat_dim = feat_dim
        self.n_parts = n_parts
        self.crop_h, self.crop_w = crop_size
        self.use_parts = use_parts
        self.ibn = ibn
        self.checkpoint_path = checkpoint_path
        self.device = resolve_device(device)
        self._model = None
        self._consts = None

    def _build(self):
        self._model = build_osnet(type(self).__name__, self.variant,
                                  self.feat_dim, self.n_parts, self.ibn,
                                  self.checkpoint_path, self.device)
        self._consts = tuple(torch.tensor(c, dtype=torch.float32,
                                          device=self.device)
                             for c in (IMAGENET_MEAN, IMAGENET_STD))

    def preprocess(self, image, detection: pd.Series, metadata: pd.Series):
        """Host thread: the detection's crop, resized with OpenCV."""
        import cv2

        from tracklab_torch.utils.cv2 import crop_bbox
        crop = crop_bbox(image, detection["bbox_ltwh"])
        crop = cv2.resize(crop, (self.crop_w, self.crop_h),
                          interpolation=cv2.INTER_LINEAR).astype(np.float32)
        return {"crop": crop}

    def process(self, batch, detections: pd.DataFrame,
                metadatas: pd.DataFrame):
        if self._model is None:
            self._build()
        mean, std = self._consts
        crops = torch.from_numpy(np.asarray(batch["crop"])).to(self.device)
        out = self._model((crops - mean) / std)
        result = pd.DataFrame(index=detections.index)
        if self.use_parts:
            result["embeddings"] = list(out["part_features"].cpu().numpy())
            result["visibility_scores"] = list(
                out["visibility"].cpu().numpy())
        else:
            result["embeddings"] = list(out["embeddings"].cpu().numpy())
            result["visibility_scores"] = [
                np.ones(1, np.float32)] * len(detections)
        return result

    def train(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format(
            "OSNetReId.train", "6: training"))
