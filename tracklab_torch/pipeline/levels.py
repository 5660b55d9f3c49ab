"""Granularity-level module ABCs and the Evaluator contract (counterpart of
tracklab_tpu.pipeline.levels).

Image- and detection-level modules are fed by the engine's thread-pool
loader (``datastruct/datapipe.py``): decode and ``preprocess`` (of a frame,
or of one detection row's crop) run on host threads, ``process`` runs a
collated batch on the module's device.
"""
from __future__ import annotations

from abc import abstractmethod
from typing import Any

import pandas as pd

from tracklab_torch.pipeline.module import Module
from tracklab_torch.utils.collate import default_collate

__all__ = ["ImageLevelModule", "DetectionLevelModule", "VideoLevelModule",
           "Evaluator"]


class ImageLevelModule(Module):
    """Modules that process full images (detectors, ...).

    Subclasses implement
      ``preprocess(image, detections, metadata) -> sample`` (host thread) and
      ``process(batch, detections, metadatas) -> detection rows``.
    """

    collate_fn = staticmethod(default_collate)

    def __init__(self, batch_size: int):
        self.batch_size = batch_size

    @abstractmethod
    def preprocess(self, image, detections: pd.DataFrame,
                   metadata: pd.Series) -> Any:
        ...

    @abstractmethod
    def process(self, batch: Any, detections: pd.DataFrame,
                metadatas: pd.DataFrame):
        ...


class DetectionLevelModule(Module):
    """Modules that process one detection row at a time (ReID on host
    crops, ...).

    Subclasses implement
      ``preprocess(image, detection, metadata) -> sample`` (host thread) and
      ``process(batch, detections, metadatas) -> detection rows``.
    """

    collate_fn = staticmethod(default_collate)

    def __init__(self, batch_size: int):
        self.batch_size = batch_size

    @abstractmethod
    def preprocess(self, image, detection: pd.Series,
                   metadata: pd.Series) -> Any:
        ...

    @abstractmethod
    def process(self, batch: Any, detections: pd.DataFrame,
                metadatas: pd.DataFrame):
        ...


class VideoLevelModule(Module):
    """Modules that process a whole video at once (the scan trackers)."""

    @abstractmethod
    def process(self, detections: pd.DataFrame,
                metadatas: pd.DataFrame) -> pd.DataFrame:
        ...


class Evaluator:
    """Evaluation wrapper contract."""

    def __init__(self, cfg):
        self.cfg = cfg

    @abstractmethod
    def run(self, tracker_state):
        ...
