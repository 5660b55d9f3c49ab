"""Host input pipeline: per-module sample decode and batched prefetch
(counterpart of tracklab_tpu.datastruct.datapipe).

Image decode and ``module.preprocess`` run on host threads while the card
works on the previous batch. Those threads do host work only: a module's
``preprocess`` returns numpy arrays and launches nothing on the card, so
no CUDA stream is shared across threads.
"""
from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import pandas as pd

from tracklab_torch.utils.cv2 import cv2_load_image

log = logging.getLogger(__name__)

__all__ = ["EngineDatapipe", "PrefetchLoader"]


class EngineDatapipe:
    """Index-addressable view over a video's image rows; each item is
    decoded and module-preprocessed."""

    def __init__(self, model):
        self.model = model
        self.image_filepaths = None
        self.img_metadatas = None
        self.detections = None

    def update(self, image_filepaths: dict, metadatas: pd.DataFrame,
               detections: Optional[pd.DataFrame]):
        self.image_filepaths = image_filepaths
        self.img_metadatas = metadatas
        self.detections = detections

    def __len__(self):
        return len(self.img_metadatas)

    def __getitem__(self, idx):
        metadata = self.img_metadatas.iloc[idx]
        if self.detections is not None and len(self.detections):
            dets = self.detections[
                self.detections["image_id"] == metadata.name]
        else:
            dets = pd.DataFrame()
        image = cv2_load_image(self.image_filepaths[metadata.name])
        sample = self.model.preprocess(
            image=image, detections=dets, metadata=metadata)
        return metadata.name, sample


class PrefetchLoader:
    """Batched iterator with thread-parallel item decode and one batch of
    lookahead."""

    def __init__(self, datapipe: EngineDatapipe, batch_size: int,
                 collate_fn, num_workers: int = 4):
        self.datapipe = datapipe
        self.batch_size = max(int(batch_size), 1)
        self.collate_fn = collate_fn
        self.num_workers = max(int(num_workers), 1)

    def __len__(self):
        return -(-len(self.datapipe) // self.batch_size)

    def __iter__(self):
        n = len(self.datapipe)
        if n == 0:
            return
        batches = [range(i, min(i + self.batch_size, n))
                   for i in range(0, n, self.batch_size)]
        with ThreadPoolExecutor(self.num_workers) as pool:
            def submit(b):
                return [pool.submit(self.datapipe.__getitem__, i)
                        for i in batches[b]]

            # submit batch b + 1 while batch b is consumed
            pending = submit(0)
            for b in range(len(batches)):
                items = [f.result() for f in pending]
                if b + 1 < len(batches):
                    pending = submit(b + 1)
                yield (np.array([it[0] for it in items]),
                       self.collate_fn([it[1] for it in items]))
