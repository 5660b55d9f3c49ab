"""YOLOX detector module: images -> bbox columns (counterpart of
tracklab_tpu.wrappers.bbox_detector.yolox_api).

Host threads decode and letterbox each frame (:func:`letterbox`, in torch
on the CPU: no OpenCV); the card runs the f32 detector and NMS on a batch
(``engine/fused.py:make_yolox_detect_fn``; on CUDA its dense CSPLayers are
kernel K3); the fixed-shape outputs come back as detection rows (image_id,
video_id, category_id, bbox_ltwh, bbox_conf) with global row ids.

Weights: ``checkpoint_path`` names a checkpoint that
``models/convert.py:load_checkpoint`` reads: the port's (Megvii's) state
dict (``models/convert.py:yolox_from_flax`` writes one from the JAX
package's tree), a Megvii training file, a TorchScript archive or an .onnx
file; without one, the weights are seeded random (``YOLOX.randomize_(0)``,
an explicit torch.Generator).

Training: ``train`` fine-tunes the model on a tracking set's ground truth
(``models/detector_train_engine.py:train_detector``); ``main.py`` calls it
under ``train_tracking=true`` (``training_enabled``), and the next
``process`` detects with the trained weights.
"""
from __future__ import annotations

import logging
from typing import Any

import numpy as np
import pandas as pd
import torch
import torch.nn.functional as F

from tracklab_torch.device import resolve_device
from tracklab_torch.pipeline.levels import ImageLevelModule
from tracklab_torch.utils.collate import default_collate

log = logging.getLogger(__name__)

__all__ = ["YOLOXDetector", "letterbox"]

_NOT_PORTED = ("{} is not ported to tracklab_torch yet (ROADMAP item 6: "
               "training and quantization)")


def _resize_bilinear(image: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """uint8 (H, W, 3) -> (nh, nw, 3): bilinear with half-pixel centres and
    no antialias (cv2.INTER_LINEAR's sampling), computed in f32 and rounded
    to the nearest grey level. The identity where the size is unchanged."""
    if image.shape[:2] == (nh, nw):
        return image
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)
    y = F.interpolate(x[None].float(), size=(nh, nw), mode="bilinear",
                      align_corners=False, antialias=False)[0]
    return y.round_().clamp_(0, 255).to(torch.uint8).permute(1, 2, 0) \
        .contiguous().numpy()


def letterbox(image: np.ndarray, input_size) -> dict:
    """Fit an RGB uint8 frame into ``input_size`` (h, w) keeping its aspect
    ratio, centred on a 114-grey canvas. Returns the canvas and the meta
    that maps boxes back: ``scale``, ``pad`` [left, top], ``shape`` [w0, h0]."""
    h0, w0 = image.shape[:2]
    th, tw = input_size
    scale = min(th / h0, tw / w0)
    nh, nw = int(round(h0 * scale)), int(round(w0 * scale))
    canvas = np.full((th, tw, 3), 114, np.uint8)
    top, left = (th - nh) // 2, (tw - nw) // 2
    canvas[top:top + nh, left:left + nw] = _resize_bilinear(image, nh, nw)
    return {"image": canvas, "scale": np.float32(scale),
            "pad": np.array([left, top], np.float32),
            "shape": np.array([w0, h0], np.float32)}


class YOLOXDetector(ImageLevelModule):
    input_columns = []
    output_columns = ["image_id", "video_id", "category_id", "bbox_ltwh",
                      "bbox_conf"]
    collate_fn = staticmethod(default_collate)
    # the engine's fused path can run this detector, NMS and a tracker as
    # one device program (engine/fused.py:run_fused_video)
    supports_fused_detect = True
    # main.py trains it under train_tracking=true (train_detector)
    training_enabled = True

    def __init__(self, variant: str = "s", num_classes: int = 1,
                 input_size=(640, 640), min_confidence: float = 0.4,
                 nms_iou: float = 0.65, max_dets: int = 64,
                 batch_size: int = 8, checkpoint_path: str | None = None,
                 class_offset: int = 1, quant: str | None = None,
                 device=None, **kwargs):
        super().__init__(batch_size)
        if quant is not None:
            raise NotImplementedError(_NOT_PORTED.format(f"quant={quant!r}"))
        self.variant = variant
        self.num_classes = num_classes
        self.input_size = tuple(input_size)
        self.min_confidence = min_confidence
        self.nms_iou = nms_iou
        self.max_dets = max_dets
        self.class_offset = class_offset
        self.checkpoint_path = checkpoint_path
        self.device = resolve_device(device)
        self._model = None
        self._detect = None
        self.id = 0  # global detection row id

    def _make_model(self):
        from tracklab_torch.models.yolox import YOLOX
        return YOLOX(num_classes=self.num_classes, variant=self.variant,
                     device=self.device)

    # the family's input scale, applied on the card after the cast to f32:
    # YOLOX reads raw 0-255 pixels
    _preproc = None

    def _build(self):
        model = self._make_model()
        if self.checkpoint_path:
            from tracklab_torch.models.convert import load_checkpoint
            load_checkpoint(self.checkpoint_path, model)
        else:
            log.warning("%s: no checkpoint_path given — running with "
                        "random weights", type(self).__name__)
            model.randomize_(0)
        self._model = model
        self._detect = self._staged_detect_fn()

    def _detect_fn(self):
        """The staged closure, (re)built where the model is new or was
        trained since."""
        if self._model is None:
            self._build()
        elif self._detect is None:
            self._detect = self._staged_detect_fn()
        return self._detect

    def _staged_detect_fn(self):
        """The closure ``process`` runs on a batch (boxes in input pixels):
        the fused path's own, so that the two give the same rows."""
        return self.device_detect_fn()

    def device_detect_fn(self):
        """``(frames, meta) -> Detections`` on the card for the fused path,
        the same math as ``process`` (the device unletterbox repeats the
        host's rescale, clip and drop)."""
        from tracklab_torch.engine.fused import make_yolox_detect_fn
        if self._model is None:
            self._build()
        return make_yolox_detect_fn(
            self._model, conf_threshold=self.min_confidence,
            iou_threshold=self.nms_iou, max_dets=self.max_dets,
            compute_dtype=torch.float32, preproc=self._preproc)

    @staticmethod
    def crop_meta(meta):
        """Per-frame affine from output boxes back into the letterboxed
        frame, ``frame_xy = out_xy * scale + pad`` (the inverse of the
        unletterbox), for device crops."""
        s = np.asarray(meta["scale"], np.float32)
        return {"scale": np.stack([s, s], axis=1),
                "pad": np.asarray(meta["pad"], np.float32)}

    def preprocess(self, image, detections, metadata) -> Any:
        """Host thread: letterbox the decoded RGB frame (no CUDA work)."""
        return letterbox(image, self.input_size)

    def process(self, batch, detections, metadatas: pd.DataFrame):
        # a short last batch is padded with zero frames to batch_size, as
        # the fused path pads its last chunk: every frame then goes through
        # the same batch shape on both paths (convolution algorithms, and
        # so their rounding, may depend on the batch size)
        images = batch["image"]
        n = len(images)
        if n < self.batch_size:
            images = np.concatenate([images, np.zeros(
                (self.batch_size - n,) + images.shape[1:], images.dtype)])
        det = self._detect_fn()(torch.from_numpy(images).to(self.device))
        ltrb, score, cls, valid = (x[:n].cpu().numpy() for x in
                                   (det.ltrb, det.conf, det.cls, det.valid))
        lo, hi = self._to_frame(batch, ltrb)
        wh = hi - lo
        keep = valid & (wh[..., 0] > 0) & (wh[..., 1] > 0)
        fs, ds = np.nonzero(keep)
        rows = self._rows(metadatas, fs, lo[fs, ds], wh[fs, ds],
                          cls[fs, ds], score[fs, ds])
        return rows

    @staticmethod
    def _to_frame(batch, ltrb):
        """Host unletterbox in f32: boxes (B, D, 4) in input pixels -> (lo,
        hi) corners in frame pixels, rescaled and clipped to the image (the
        caller drops the boxes that collapse)."""
        scale = np.asarray(batch["scale"], np.float32)[:, None, None]
        pad = np.asarray(batch["pad"], np.float32)[:, None, :]
        wh0 = np.asarray(batch["shape"], np.float32)[:, None, :]
        return (np.clip((ltrb[..., 0:2] - pad) / scale, 0, wh0),
                np.clip((ltrb[..., 2:4] - pad) / scale, 0, wh0))

    def _rows(self, metadatas, fs, lt, wh, cls, score):
        """Detection rows of frames ``metadatas.index[fs]``, numbered from
        the module's running row id."""
        ids = self.id + np.arange(len(fs))
        self.id += len(fs)
        image_ids = metadatas.index.to_numpy()[fs]
        boxes = np.concatenate([lt, wh], axis=1).astype(np.float32)
        return pd.DataFrame({
            "image_id": image_ids,
            "video_id": metadatas["video_id"].to_numpy()[fs],
            "category_id": cls.astype(np.int64) + self.class_offset,
            "bbox_ltwh": list(boxes),
            "bbox_conf": score.astype(np.float64),
        }, index=ids)

    def train(self, tracking_dataset, pipeline=None, evaluator=None,
              dataset_cfg=None, **kwargs):
        """Fine-tune on the dataset's ground-truth boxes (the JAX wrapper's
        ``train``): ``train_detector``, ``kwargs`` its arguments."""
        from tracklab_torch.models.detector_train_engine import (
            train_detector,
        )
        return train_detector(self, tracking_dataset, **kwargs)
