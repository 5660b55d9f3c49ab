"""Host input pipeline: per-module sample decode and batched prefetch
(counterpart of tracklab_tpu.datastruct.datapipe).

Image decode and ``module.preprocess`` run on host threads while the card
works on the previous batch. Those threads do host work only: a module's
``preprocess`` returns numpy arrays and launches nothing on the card, so
no CUDA stream is shared across threads. An image-level module's items are
frames; a detection-level module's items are detection rows, each with its
frame. The rows of a frame are consecutive, so a frame is decoded once for
all its rows, and the next frames are decoded ahead on threads of their own
(a frame at a time would keep every item thread waiting on one decode).
"""
from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import pandas as pd

from tracklab_torch.utils.cv2 import cv2_load_image

log = logging.getLogger(__name__)

__all__ = ["EngineDatapipe", "PrefetchLoader"]


class EngineDatapipe:
    """Index-addressable view over a video's image rows, or its detection
    rows for a detection-level module; each item is decoded and
    module-preprocessed."""

    _DECODE_AHEAD = 4     # frames decoded ahead of the one asked for
    _KEEP_IMAGES = 10

    def __init__(self, model, decode_workers: int = 4):
        self.model = model
        self.image_filepaths = None
        self.img_metadatas = None
        self.detections = None
        self.decode_workers = max(int(decode_workers), 1)
        self._lock = threading.Lock()
        self._images = OrderedDict()    # image id -> future of the frame
        self._position = {}
        self._decoder = None

    def update(self, image_filepaths: dict, metadatas: pd.DataFrame,
               detections: Optional[pd.DataFrame]):
        self.image_filepaths = image_filepaths
        self.img_metadatas = metadatas
        self.detections = detections
        with self._lock:
            self._images.clear()
            self._position = {iid: i for i, iid in enumerate(metadatas.index)}

    def __len__(self):
        if self.model.level == "detection":
            return 0 if self.detections is None else len(self.detections)
        return len(self.img_metadatas)

    def _image(self, image_id):
        """The decoded frame ``image_id``; its decode, and that of the next
        ``_DECODE_AHEAD`` frames of the video, start on the decode threads
        the first time a row asks for them."""
        with self._lock:
            if self._decoder is None:
                self._decoder = ThreadPoolExecutor(self.decode_workers)
            order = self.img_metadatas.index
            at = self._position[image_id]
            for iid in order[at:at + self._DECODE_AHEAD + 1]:
                if iid not in self._images:
                    self._images[iid] = self._decoder.submit(
                        cv2_load_image, self.image_filepaths[iid])
            frame = self._images[image_id]
            while len(self._images) > self._KEEP_IMAGES:
                self._images.popitem(last=False)
        return frame.result()

    def __getitem__(self, idx):
        if self.model.level == "detection":
            detection = self.detections.iloc[idx]
            metadata = self.img_metadatas.loc[detection["image_id"]]
            sample = self.model.preprocess(
                image=self._image(metadata.name), detection=detection,
                metadata=metadata)
            return detection.name, sample
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
