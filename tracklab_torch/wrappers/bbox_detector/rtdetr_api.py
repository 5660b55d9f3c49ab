"""RT-DETR detector module (counterpart of
tracklab_tpu.wrappers.bbox_detector.rtdetr_api): NMS-free query-based
detection -> bbox columns, two model families behind one wrapper.

- ``variant`` in ``HF_VARIANTS`` (r18vd .. r101vd): the HF-exact RT-DETR
  (``models/rtdetr_hf.py``), the PekingU checkpoints the reference's RTDetr
  wrapper loads. Its preprocessing is RTDetrImageProcessor's: a stretch
  resize to ``input_size`` (bilinear, half-pixel centres), pixels / 255, no
  normalisation, no letterbox; boxes map back by a per-axis scale. The
  fused engine runs it (``engine/fused.py:make_rtdetr_detect_fn``).
- any other variant (a YOLOX width): the lightweight query detector
  (``models/rtdetr.py``) behind the shared letterbox; staged only, as in
  the JAX package (its ``device_detect_fn`` raises, and
  ``supports_fused_detect`` is false).

Weights: ``checkpoint_path`` names a ``torch.save``d state dict: for the HF
variants the port's own (``rtdetr_hf_from_flax``) or an HF one, both
through ``convert_rtdetr_hf_torch``; for the lightweight one the port's own
(``rtdetr_from_flax``), loaded with ``strict=True``. Without one the
weights are seeded random, with a warning.
"""
from __future__ import annotations

import numpy as np
import torch

from tracklab_torch.trackers.common import Detections
from tracklab_torch.wrappers.bbox_detector.yolox_api import (
    _NOT_PORTED, YOLOXDetector, _resize_bilinear)

__all__ = ["RTDETRDetector"]


class RTDETRDetector(YOLOXDetector):
    HF_VARIANTS = ("r18vd", "r34vd", "r50vd", "r101vd")

    def __init__(self, *args, num_queries: int = 100, **kwargs):
        self.num_queries = num_queries
        super().__init__(*args, **kwargs)

    @property
    def _hf_mode(self):
        return self.variant in self.HF_VARIANTS

    @property
    def supports_fused_detect(self):
        # the offline engine gates its fused branch on this attribute
        return self._hf_mode

    def _make_model(self):
        if self._hf_mode:
            from tracklab_torch.models.rtdetr_hf import RTDetrHF
            return RTDetrHF(variant=self.variant,
                            num_labels=max(self.num_classes, 1),
                            device=self.device)
        from tracklab_torch.models.rtdetr import RTDETR
        return RTDETR(num_classes=self.num_classes,
                      num_queries=self.num_queries, variant=self.variant,
                      input_size=self.input_size, device=self.device)

    def _staged_detect_fn(self):
        if self._hf_mode:
            return self.device_detect_fn()
        from tracklab_torch.models.rtdetr_hf import stable_topk

        model, min_conf = self._model, self.min_confidence
        k = min(self.max_dets, self.num_queries)

        def detect(frames, meta=None) -> Detections:
            # the top max_dets queries by score, NMS-free
            xywh, scores, classes = model.predict(frames.float() / 255.0)
            top_s, top_i = stable_topk(scores, k)
            b = torch.gather(xywh, 1, top_i[..., None].expand(-1, -1, 4))
            ltrb = torch.cat([b[..., :2] - b[..., 2:] / 2,
                              b[..., :2] + b[..., 2:] / 2], dim=-1)
            ref = torch.arange(k, dtype=torch.int32,
                               device=ltrb.device).expand(len(ltrb), k)
            return Detections(ltrb, top_s,
                              torch.gather(classes, 1, top_i).float(), ref,
                              top_s >= min_conf)
        return detect

    def device_detect_fn(self):
        """``(frames, meta) -> Detections`` on the card for the fused path,
        HF variants only: NMS-free top-k, boxes mapped back through the
        per-axis stretch scale, the same math as ``process``."""
        if not self._hf_mode:
            raise NotImplementedError(
                "fused engine path supports the HF RT-DETR variants "
                f"{self.HF_VARIANTS}; variant={self.variant!r} uses the "
                "staged engine")
        from tracklab_torch.engine.fused import make_rtdetr_detect_fn
        if self._model is None:
            self._build()
        return make_rtdetr_detect_fn(
            self._model, self.input_size,
            conf_threshold=self.min_confidence, max_dets=self.max_dets)

    def crop_meta(self, meta):
        """Output box -> detector-frame affine for device crops: the
        letterbox's, or for the HF variants ``frame_xy = out_xy / scale``
        (the stretch-resized frame, no padding)."""
        if not self._hf_mode:
            return super().crop_meta(meta)
        s = np.asarray(meta["scale"], np.float32)
        return {"scale": 1.0 / s, "pad": np.zeros_like(s)}

    def preprocess(self, image, detections, metadata):
        if not self._hf_mode:
            return super().preprocess(image, detections, metadata)
        h0, w0 = image.shape[:2]
        th, tw = self.input_size
        return {"image": _resize_bilinear(image, th, tw),
                # stretch resize: a per-axis scale, no padding
                "scale": np.array([w0 / tw, h0 / th], np.float32),
                "pad": np.zeros(2, np.float32),
                "shape": np.array([w0, h0], np.float32)}

    def _to_frame(self, batch, ltrb):
        if not self._hf_mode:
            return super()._to_frame(batch, ltrb)
        sxy = np.asarray(batch["scale"], np.float32)[:, None, :]
        wh0 = np.asarray(batch["shape"], np.float32)[:, None, :]
        return (np.clip(ltrb[..., 0:2] * sxy, 0, wh0),
                np.clip(ltrb[..., 2:4] * sxy, 0, wh0))

    def detection_loss_fn(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format(
            "RTDETRDetector.detection_loss_fn"))

    # its training is not ported (ROADMAP item 6): main.py does not call it
    training_enabled = False

    def train(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format("RTDETRDetector.train"))
