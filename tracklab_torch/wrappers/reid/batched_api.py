"""Batched ReID on the card: every detection of a batch of frames in one
OSNet forward (counterpart of tracklab_tpu.wrappers.reid.batched_api).

An ImageLevelModule: the loader threads resize each frame to the work size
with OpenCV and pad its boxes (in work coordinates) to ``max_dets`` slots;
the card crops every slot (``models/preprocess.py:crop_resize``), normalises
and runs ``models/osnet.py:OSNet`` over the batch
(``engine/fused.py:make_osnet_embed_fn``). The engine's fused path can run
this module between a fused detector and an embedding tracker in one device
program (``engine/fused.py:run_fused_reid_video``); its crops then come
from the detector's letterboxed frames, which are this module's work image
when the work size equals the detector's input and the frame size.

Weights: ``checkpoint_path`` as ``OSNetReId``'s (``osnet_api.build_osnet``):
the port's or a torchreid state dict, or the JAX package's orbax checkpoint
directory.
"""
from __future__ import annotations

import logging

import numpy as np
import pandas as pd
import torch

from tracklab_torch.device import resolve_device
from tracklab_torch.pipeline.levels import ImageLevelModule
from tracklab_torch.utils.collate import default_collate
from tracklab_torch.wrappers.reid.osnet_api import build_osnet

log = logging.getLogger(__name__)

__all__ = ["OSNetReIdBatched"]


class OSNetReIdBatched(ImageLevelModule):
    input_columns = ["bbox_ltwh"]
    output_columns = ["embeddings", "visibility_scores"]
    collate_fn = staticmethod(default_collate)
    # the engine's fused path can put this module between a fused detector
    # and an embedding tracker (engine/fused.py:run_fused_reid_video)
    supports_fused_embed = True

    def __init__(self, variant: str = "x1_0", feat_dim: int = 512,
                 n_parts: int = 6, crop_size=(256, 128),
                 work_size=(736, 1280), max_dets: int = 32,
                 batch_size: int = 4, use_parts: bool = True,
                 ibn: bool = False, checkpoint_path: str | None = None,
                 device=None, embed_buckets=None, **kwargs):
        super().__init__(batch_size)
        self.variant = variant
        self.feat_dim = feat_dim
        self.n_parts = n_parts
        self.crop_h, self.crop_w = crop_size
        self.work_h, self.work_w = work_size
        self.max_dets = max_dets
        self.use_parts = use_parts
        self.ibn = ibn
        self.checkpoint_path = checkpoint_path
        self.device = resolve_device(device)
        # live-prefix widths for the fused path (engine/fused.py:
        # _bucketed_embed, one host read per chunk); None embeds every slot
        self.embed_buckets = (tuple(embed_buckets) if embed_buckets
                              else None)
        self._model = None
        self._embed = None

    def _build(self):
        self._model = build_osnet(type(self).__name__, self.variant,
                                  self.feat_dim, self.n_parts, self.ibn,
                                  self.checkpoint_path, self.device)
        self._embed = self.device_embed_fn()

    def device_embed_fn(self):
        """``(frames, boxes) -> dict`` on the card: device crops + OSNet,
        the same math as ``process`` (for the fused path the frames are the
        detector's)."""
        from tracklab_torch.engine.fused import make_osnet_embed_fn
        if self._model is None:
            self._build()
        return make_osnet_embed_fn(self._model,
                                   crop_size=(self.crop_h, self.crop_w))

    def preprocess(self, image, detections: pd.DataFrame,
                   metadata: pd.Series):
        """Host thread: the work image and the frame's boxes in work
        coordinates, padded to ``max_dets`` (row id -1 on empty slots)."""
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
        return {"image": work, "boxes": boxes, "rows": rows}

    def process(self, batch, detections: pd.DataFrame,
                metadatas: pd.DataFrame):
        if self._model is None:
            self._build()
        # a short last batch is padded to batch_size with empty frames, so
        # every frame goes through one batch shape (convolution algorithms,
        # and so their rounding, may depend on it)
        images, boxes = batch["image"], batch["boxes"]
        n = len(images)
        if n < self.batch_size:
            pad = self.batch_size - n
            images = np.concatenate([images, np.zeros(
                (pad,) + images.shape[1:], images.dtype)])
            boxes = np.concatenate([boxes, np.zeros(
                (pad,) + boxes.shape[1:], boxes.dtype)])
        out = self._embed(torch.from_numpy(images).to(self.device),
                          torch.from_numpy(boxes).to(self.device))
        rows = np.asarray(batch["rows"])
        return self._rows(out, rows, np.nonzero(rows >= 0))

    def _rows(self, out, rows, slots):
        """The output rows of the embedded ``slots`` (frame and slot index
        arrays into ``out``'s leading (frames, slots) axes), indexed by
        ``rows[slots]``: the part layout and its visibility with
        ``use_parts``, else the global feature and a visibility of 1."""
        result = pd.DataFrame(index=rows[slots])
        if self.use_parts:
            result["embeddings"] = list(
                out["part_features"].cpu().numpy()[slots])
            result["visibility_scores"] = list(
                out["visibility"].cpu().numpy()[slots])
        else:
            result["embeddings"] = list(
                out["embeddings"].cpu().numpy()[slots])
            result["visibility_scores"] = [
                np.ones(1, np.float32)] * len(result)
        return result
