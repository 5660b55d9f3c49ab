"""Per-video and per-module frames/s on the host clock (counterpart of
tracklab_tpu.callbacks.timer). The times are kept on the callback:
``total_frames``, ``dataset_seconds`` and ``module_time`` (seconds per
module between its start and end hooks)."""
from __future__ import annotations

import logging
import time
from collections import defaultdict

from tracklab_torch.callbacks.callback import Callback

log = logging.getLogger(__name__)

__all__ = ["Timer"]


class Timer(Callback):
    def __init__(self, **kwargs):
        # per video: its start time and frame count (the batched engine
        # starts a batch's videos before it ends any)
        self.videos = {}
        self.dataset_start = None
        self.dataset_seconds = None
        self.module_start = {}
        self.module_time = defaultdict(float)
        self.total_frames = 0

    def on_dataset_track_start(self, engine):
        self.dataset_start = time.perf_counter()

    def on_video_loop_start(self, engine, video_metadata, video_idx, index):
        self.videos[video_idx] = (time.perf_counter(),
                                  int(video_metadata.get("nframes", 0) or 0))

    def on_video_loop_end(self, engine, video_metadata, video_idx,
                          detections, image_pred):
        start, frames = self.videos.pop(video_idx)
        dt = time.perf_counter() - start
        if frames == 0 and image_pred is not None:
            frames = len(image_pred)
        self.total_frames += frames
        log.info("Video %s: %.2fs (%.1f FPS)",
                 video_metadata.get("name", video_idx), dt,
                 frames / dt if dt > 0 else float("nan"))

    def on_module_start(self, engine, task, dataloader):
        self.module_start[task] = time.perf_counter()

    def on_module_end(self, engine, task, detections):
        if task in self.module_start:
            self.module_time[task] += (time.perf_counter()
                                       - self.module_start.pop(task))

    def on_dataset_track_end(self, engine):
        dt = self.dataset_seconds = time.perf_counter() - self.dataset_start
        log.info("Dataset tracked in %.2fs — %d frames (%.1f FPS)",
                 dt, self.total_frames,
                 self.total_frames / dt if dt > 0 else float("nan"))
        for task, t in sorted(self.module_time.items()):
            log.info("  module %-24s %8.2fs (%.1f FPS)", task, t,
                     self.total_frames / t if t > 0 else float("nan"))
