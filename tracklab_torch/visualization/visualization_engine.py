"""Visualization engine: a callback that, after each video is saved,
renders its frames with the configured visualizers and writes an mp4
and/or jpgs (counterpart of tracklab_tpu.visualization.
visualization_engine).

Rendering is host work on numpy frames and DataFrames: in threads, or with
``parallel_backend: process`` in spawned processes (the parent holds a
CUDA context, which a forked child must not inherit). A frame that cannot
be loaded or drawn is skipped with a warning. Stateful visualizers (track
trails) render serially.
"""
from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import pandas as pd

from tracklab_torch.callbacks.callback import Callback
from tracklab_torch.utils.cv2 import cv2_load_image
from tracklab_torch.utils.parallel import parallel_map

log = logging.getLogger(__name__)

__all__ = ["VisualizationEngine"]


def _render(visualizers, file_path, frame_pred, frame_gt, metadata):
    """One frame drawn by every visualizer; None if it cannot be loaded."""
    try:
        image = cv2_load_image(file_path)
    except Exception as e:  # a missing frame must not end the run
        log.warning("visualization: cannot load %s (%s)", file_path, e)
        return None
    image = np.ascontiguousarray(image)
    for v in visualizers:
        try:
            v.draw_frame(image, frame_pred, frame_gt, metadata)
        except Exception as e:
            log.warning("visualizer %s failed on frame %s: %s",
                        type(v).__name__, metadata.get("frame"), e)
    return image


def _render_chunk(payload):
    """A process worker: render a chunk of frames (module-level, so that
    it pickles)."""
    visualizers, items = payload
    return [_render(visualizers, *item) for item in items]


class VisualizationEngine(Callback):
    after_saved_state = True

    def __init__(self, visualizers=None, save_videos: bool = True,
                 save_images: bool = False, save_folder: str = "visuals",
                 fps: int = 30, num_workers: int = 4,
                 parallel_backend: str = "thread",
                 process_n_videos: int = -1, video_fmt: str = "mp4v",
                 **kwargs):
        if visualizers is None:
            from tracklab_torch.visualization.detection import (
                DefaultDetectionVisualizer,
            )
            visualizers = [DefaultDetectionVisualizer()]
        if isinstance(visualizers, dict):
            visualizers = list(visualizers.values())
        self.visualizers = visualizers
        self.save_videos = save_videos
        self.save_images = save_images
        self.save_folder = Path(save_folder)
        self.fps = fps
        self.num_workers = num_workers
        self.parallel_backend = parallel_backend
        self.process_n_videos = process_n_videos
        self.video_fmt = video_fmt
        self._videos_done = 0

    def on_video_loop_end(self, engine, video_metadata, video_idx,
                          detections, image_pred):
        if 0 <= self.process_n_videos <= self._videos_done:
            return
        self._videos_done += 1
        if image_pred is None or len(image_pred) == 0:
            return
        gt = getattr(engine.tracker_state, "detections_gt", None)
        video_gt = gt[gt.video_id == video_idx] \
            if gt is not None and len(gt) else None
        name = video_metadata.get("name", str(video_idx))
        self.save_folder.mkdir(parents=True, exist_ok=True)
        for v in self.visualizers:
            if hasattr(v, "reset"):
                v.reset()

        def item(image_id, metadata):
            frame_pred = (detections[detections["image_id"] == image_id]
                          if detections is not None and len(detections)
                          else pd.DataFrame())
            frame_gt = (video_gt[video_gt["image_id"] == image_id]
                        if video_gt is not None else None)
            return (metadata["file_path"], frame_pred, frame_gt,
                    dict(metadata))

        items = [item(*it) for it in image_pred.iterrows()]
        stateful = any(hasattr(v, "reset") for v in self.visualizers)
        if stateful or self.num_workers <= 1:
            frames = [_render(self.visualizers, *it) for it in items]
        elif self.parallel_backend == "process":
            n = -(-len(items) // self.num_workers)
            chunks = [(self.visualizers, items[i:i + n])
                      for i in range(0, len(items), n)]
            frames = [f for chunk in parallel_map(
                _render_chunk, chunks, self.num_workers, "process")
                for f in chunk]
        else:
            frames = parallel_map(lambda it: _render(self.visualizers, *it),
                                  items, self.num_workers, "thread")
        frames = [f for f in frames if f is not None]
        if frames:
            self._save(name, frames)

    def _save(self, name, frames):
        import cv2
        if self.save_videos:
            h, w = frames[0].shape[:2]
            path = str(self.save_folder / f"{name}.mp4")
            writer = cv2.VideoWriter(
                path, cv2.VideoWriter_fourcc(*self.video_fmt), self.fps,
                (w, h))
            try:
                for f in frames:
                    writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
            finally:
                writer.release()
            log.info("Saved visualization video %s", path)
        if self.save_images:
            img_dir = self.save_folder / name
            img_dir.mkdir(parents=True, exist_ok=True)
            for i, f in enumerate(frames):
                cv2.imwrite(str(img_dir / f"{i:06d}.jpg"),
                            cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
