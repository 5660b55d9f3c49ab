"""Jersey-number recognition module (counterpart of
tracklab_tpu.wrappers.jersey.ocr_api).

A detection-level module that emits ``jersey_number_detection`` and
``jersey_number_confidence`` for MajorityVoteTracklet to aggregate per
track. It reads crops with EasyOCR where that package is installed and
finds its models on disk (nothing is downloaded); otherwise it emits empty
predictions with a warning, as the JAX module does.
"""
from __future__ import annotations

import logging

import numpy as np
import pandas as pd

from tracklab_torch.device import resolve_device
from tracklab_torch.pipeline.levels import DetectionLevelModule
from tracklab_torch.utils.collate import Unbatchable, default_collate

log = logging.getLogger(__name__)

__all__ = ["JerseyNumberOCR", "map_ocr_to_jersey"]


def map_ocr_to_jersey(ocr_results, crop_shape):
    """EasyOCR results -> (number, confidence) for the torso: keep
    digit-only readings of one or two digits whose box centre falls in the
    middle band of the crop; the most confident wins."""
    h, w = crop_shape[:2]
    best = (None, 0.0)
    for bbox, text, conf in ocr_results or []:
        text = "".join(ch for ch in str(text) if ch.isdigit())
        if not text or len(text) > 2:
            continue
        cx = np.mean([p[0] for p in bbox])
        cy = np.mean([p[1] for p in bbox])
        if not (0.1 * w < cx < 0.9 * w and 0.05 * h < cy < 0.7 * h):
            continue
        if conf > best[1]:
            best = (text, float(conf))
    return best


class JerseyNumberOCR(DetectionLevelModule):
    input_columns = ["bbox_ltwh"]
    output_columns = ["jersey_number_detection", "jersey_number_confidence"]
    collate_fn = staticmethod(default_collate)

    def __init__(self, batch_size: int = 8, min_confidence: float = 0.3,
                 device=None, **kwargs):
        super().__init__(batch_size)
        self.min_confidence = min_confidence
        self.device = resolve_device(device)
        self._reader = None
        self._checked = False

    def _reader_or_none(self):
        if self._checked:
            return self._reader
        self._checked = True
        try:
            import easyocr
        except ImportError:
            log.warning("easyocr not installed — jersey OCR emits empty "
                        "predictions")
            return None
        self._reader = easyocr.Reader(["en"],
                                      gpu=self.device.type == "cuda",
                                      download_enabled=False)
        return self._reader

    def preprocess(self, image, detection: pd.Series, metadata: pd.Series):
        from tracklab_torch.utils.cv2 import crop_bbox
        return {"crop": Unbatchable(crop_bbox(image,
                                              detection["bbox_ltwh"]))}

    def process(self, batch, detections: pd.DataFrame,
                metadatas: pd.DataFrame):
        reader = self._reader_or_none()
        numbers, confs = [], []
        for crop in batch["crop"]:
            if reader is None or crop.size == 0:
                numbers.append(None)
                confs.append(0.0)
                continue
            try:
                results = reader.readtext(crop)
            except Exception as e:   # one unreadable crop is no reading
                log.debug("OCR failed: %s", e)
                results = []
            num, conf = map_ocr_to_jersey(results, crop.shape)
            numbers.append(num if conf >= self.min_confidence else None)
            confs.append(conf)
        out = pd.DataFrame(index=detections.index)
        out["jersey_number_detection"] = numbers
        out["jersey_number_confidence"] = confs
        return out
