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

``backbone`` other than "osnet" picks a model of the ReID backbone zoo
(``select_backbone_model``: torchreid's ResNet, ResNeXt, IBN-a/b,
MobileNetV2, ShuffleNetV2, OSNet-AIN, SE-ResNet, ResNet-mid, PCB, DenseNet,
SqueezeNet, MLFN, Xception, HACNN, MuDeep, InceptionV4, InceptionResNetV2
and NASNet-A mobile): parts and keypoint prompts are off, and
``embeddings`` is the model's global feature (``visibility_scores`` 1).

Weights: ``checkpoint_path`` names a ``torch.save``d state dict, either the
port's (``models/convert.py:osnet_from_flax`` / ``reid_backbone_from_flax``
build the model from the JAX package's tree) or a torchreid one (loaded
through ``convert_osnet_torch`` / ``convert_reid_backbone_torch``), or the
JAX package's orbax checkpoint directory (mapped by the same flax maps);
without one the weights are seeded random (``randomize_(0)``).

Training: ``main.py`` calls ``train`` under ``train_tracking=true``
(``training_enabled``, as in the JAX package); it trains an OSNet on the
set's ground-truth crops (``models/reid_train.py``), which the next
``process`` embeds with unless a ``checkpoint_path`` is given.
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

__all__ = ["OSNetReId", "build_osnet", "select_backbone_model"]


def build_osnet(owner: str, variant: str, feat_dim: int, n_parts: int,
                ibn: bool, checkpoint_path, device, in_channels: int = 3):
    """An ``OSNet`` on ``device`` with the weights of ``checkpoint_path``
    (the port's state dict, loaded strict, or a torchreid state dict, whose
    part head keeps seeded weights), else seeded random weights."""
    from tracklab_torch.models.convert import load_checkpoint
    from tracklab_torch.models.osnet import OSNet

    model = OSNet(variant, feat_dim, n_parts, ibn=ibn,
                  in_channels=in_channels, device="cpu")
    model.randomize_(0)
    if checkpoint_path:
        load_checkpoint(checkpoint_path, model)
    else:
        log.warning("%s: no checkpoint_path given — running with random "
                    "weights", owner)
    return model.to(resolve_device(device))


def select_backbone_model(backbone, variant="x1_0", feat_dim=512, n_parts=6,
                          ibn=False, crop_size=(256, 128), device=None):
    """The model of a ``backbone=`` key (the JAX package's keys) on
    ``device`` (``cuda`` unless told otherwise) with seeded weights
    (``randomize_(0)``; none on the ``meta`` device). Raises ValueError for
    an unknown key and for HACNN and MuDeep given another crop than their
    fixed input."""
    from tracklab_torch.models.osnet import OSNet
    from tracklab_torch.models.reid_backbones import zoo_model

    dev = resolve_device(device)
    if backbone == "osnet":
        if dev.type == "meta":
            return OSNet(variant, feat_dim, n_parts, ibn=ibn, device=dev)
        model = OSNet(variant, feat_dim, n_parts, ibn=ibn, device="cpu")
        return model.randomize_(0).to(dev)
    with torch.device("meta"):
        model = zoo_model(backbone, feat_dim, crop_size)
    model = model.to_empty(device=dev)
    return model if dev.type == "meta" else model.randomize_(0)


def build_backbone(owner: str, backbone: str, feat_dim: int, crop_size,
                   checkpoint_path, device):
    """A zoo model (``select_backbone_model``) on ``device`` with the
    weights of ``checkpoint_path`` (the port's state dict or a torchreid
    one, both through ``convert_reid_backbone_torch``), else seeded random
    weights."""
    from tracklab_torch.models.convert import load_checkpoint

    model = select_backbone_model(backbone, feat_dim=feat_dim,
                                  crop_size=crop_size, device="cpu")
    if checkpoint_path:
        load_checkpoint(checkpoint_path, model)
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
        self.backbone = backbone
        if backbone != "osnet":
            # the zoo's backbones give one global feature
            use_parts = False
            use_keypoints = False
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
        self._trained = None   # the OSNet that ``train`` left
        self._consts = None
        if use_keypoints:
            self.input_columns = ["bbox_ltwh", "keypoints_xyc"]

    def _build(self):
        """The model: ``checkpoint_path``'s weights when given (as in the
        JAX package, they take the place of what ``train`` left), else the
        trained OSNet, else seeded weights."""
        in_channels = 3 + (len(self.KP_GROUPS) if self.use_keypoints else 0)
        if self._trained is not None and not self.checkpoint_path:
            if self.backbone != "osnet":
                # the JAX package stores train_reid's OSNet variables on a
                # zoo module, whose model then cannot apply them
                raise ValueError(
                    f"OSNetReId(backbone={self.backbone!r}) holds the OSNet "
                    "that train() made, which its model cannot load")
            self._model = self._trained
        elif self.backbone == "osnet":
            self._model = build_osnet(type(self).__name__, self.variant,
                                      self.feat_dim, self.n_parts, self.ibn,
                                      self.checkpoint_path, self.device,
                                      in_channels)
        else:
            self._model = build_backbone(
                type(self).__name__, self.backbone, self.feat_dim,
                (self.crop_h, self.crop_w), self.checkpoint_path, self.device)
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
            emb = out["embeddings"] if isinstance(out, dict) else out
            result["embeddings"] = list(emb.cpu().numpy())
            result["visibility_scores"] = [
                np.ones(1, np.float32)] * len(detections)
        return result

    def train(self, tracking_dataset, pipeline=None, evaluator=None,
              dataset_cfg=None, epochs: int = 5, **kwargs):
        """Train on the ground-truth crops of the dataset's train split
        (``models/reid_train.py:train_reid``, ``kwargs`` its arguments; the
        JAX wrapper's ``train``): a new OSNet of this module's variant,
        feat_dim and n_parts, whatever its weights or ``backbone=``. The
        next ``process`` rebuilds the model (``_build``)."""
        from tracklab_torch.models.reid_train import train_reid
        trained, metrics = train_reid(self, tracking_dataset, epochs=epochs,
                                      **kwargs)
        if trained is not None:
            self._trained = trained
        self._model = None
        return metrics
