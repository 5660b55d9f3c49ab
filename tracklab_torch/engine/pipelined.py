"""Pipelined engine: the modules of a video as stages of a pipeline
(counterpart of tracklab_tpu.engine.pipelined).

A video's frames are cut into chunks of ``chunk_size``; each module is a
stage on a thread of its own, joined to the next by a bounded queue
(``queue_depth`` chunks), so while the detector runs on chunk k the ReID
stage works on chunk k - 1 and the loader decodes chunk k + 1. An image- or
detection-level module is per frame, so running it chunk by chunk gives the
offline engine's rows (the detector numbers its rows in chunk order, on
one thread). A video-level module (a scan tracker) is a barrier: it
gathers every chunk, runs once over the whole video and passes the chunks
on. A stage that fails passes the end of the stream on and drains its
input, so the failure reaches the main thread, which raises it.

The stages share the card's stream; each runs with autograd off (grad
mode is per thread).
"""
from __future__ import annotations

import logging
import queue
import threading
from typing import List

import pandas as pd
import torch

from tracklab_torch.datastruct.datapipe import EngineDatapipe, PrefetchLoader
from tracklab_torch.engine.engine import TrackingEngine, merge_dataframes

log = logging.getLogger(__name__)

__all__ = ["PipelinedTrackingEngine"]

_DONE = object()


class PipelinedTrackingEngine(TrackingEngine):
    """cfg: chunk_size (frames per chunk), queue_depth (chunks a stage's
    input queue holds), num_workers (decode threads per stage)."""

    def __init__(self, *args, chunk_size: int = 32, queue_depth: int = 2,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.chunk_size = max(int(chunk_size), 1)
        self.queue_depth = max(int(queue_depth), 1)
        self._fire_lock = threading.Lock()

    def fire(self, hook: str, **kwargs):
        with self._fire_lock:
            super().fire(hook, **kwargs)

    def _run_chunk(self, name: str, detections: pd.DataFrame,
                   image_pred: pd.DataFrame):
        """One image- or detection-level module over one chunk, through a
        datapipe and loader of the stage's own."""
        model = self.models[name]
        datapipe = EngineDatapipe(model, decode_workers=self.num_workers)
        datapipe.update(dict(image_pred["file_path"].items()), image_pred,
                        detections)
        loader = PrefetchLoader(
            datapipe, batch_size=getattr(model, "batch_size", 1),
            collate_fn=model.collate_fn, num_workers=self.num_workers)
        for batch in loader:
            detections, image_pred = self.default_step(
                batch, name, detections, image_pred)
        return detections, image_pred

    def _stage(self, i: int, name: str, queues: List[queue.Queue],
               errors: list):
        model = self.models[name]
        q_in, q_out = queues[i], queues[i + 1]
        self.fire("on_module_start", task=name, dataloader=[])
        done_seen = False
        try:
            with torch.no_grad():
                if model.level == "video":
                    buf = []
                    while (item := q_in.get()) is not _DONE:
                        buf.append(item)
                    done_seen = True
                    dets = pd.concat([b[1] for b in buf]) if buf else \
                        pd.DataFrame()
                    imgs = pd.concat([b[2] for b in buf]) if buf else \
                        pd.DataFrame()
                    if len(dets):
                        dets = merge_dataframes(dets,
                                                model.process(dets, imgs))
                    for ci, _, imgs_c in buf:
                        q_out.put((ci, dets[dets["image_id"].isin(
                            imgs_c.index)] if len(dets) else dets, imgs_c))
                else:
                    while (item := q_in.get()) is not _DONE:
                        ci, dets_c, imgs_c = item
                        if len(dets_c) or model.level == "image":
                            dets_c, imgs_c = self._run_chunk(name, dets_c,
                                                             imgs_c)
                        q_out.put((ci, dets_c, imgs_c))
                    done_seen = True
        except BaseException as e:  # raised again in the main thread
            log.exception("Pipelined stage %s failed", name)
            errors.append(e)
        finally:
            q_out.put(_DONE)
            # every producer ends its output with _DONE in its own finally,
            # so draining to it frees a producer blocked on a full queue
            while not done_seen:
                done_seen = q_in.get() is _DONE
            self.fire("on_module_end", task=name, detections=pd.DataFrame())

    def video_loop(self, video_metadata: pd.Series, video_id):
        for model in self.models.values():
            if hasattr(model, "reset"):
                model.reset()
        detections, image_pred = self.tracker_state.load()
        names = self.module_names
        if not names or len(image_pred) == 0:
            return detections, image_pred

        ids = list(image_pred.index)
        chunks = [ids[i:i + self.chunk_size]
                  for i in range(0, len(ids), self.chunk_size)]
        queues = [queue.Queue(maxsize=self.queue_depth)
                  for _ in range(len(names) + 1)]
        errors: list = []
        threads = [threading.Thread(target=self._stage,
                                    args=(i, name, queues, errors),
                                    daemon=True)
                   for i, name in enumerate(names)]
        for t in threads:
            t.start()
        try:
            for ci, chunk in enumerate(chunks):
                dets_c = detections[detections["image_id"].isin(chunk)] \
                    if len(detections) else detections
                queues[0].put((ci, dets_c, image_pred.loc[chunk]))
        finally:
            queues[0].put(_DONE)
        results = []
        while (item := queues[-1].get()) is not _DONE:
            results.append(item)
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        results.sort(key=lambda r: r[0])
        if results:
            detections = pd.concat([r[1] for r in results])
            detections = detections[~detections.index.duplicated(
                keep="last")]
            image_pred = pd.concat([r[2] for r in results])
        return detections, image_pred
