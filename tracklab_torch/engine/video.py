"""Online engine: frame by frame over a video file or a webcam (counterpart
of tracklab_tpu.engine.video).

Frames come from ``cv2.VideoCapture`` (a file path, or a webcam index),
subsampled to ``target_fps``. Per frame, each image-level module runs on
the frame (a batch of one), each detection-level module on the frame's
rows (in batches of its ``batch_size``), and each video-level module
(the scan trackers) takes one step through ``process_online``, its state
kept on the device between frames. Every module is ``reset()`` at the
start of a video.

A tracker can emit a row of an earlier frame again (a coasting track
re-emits its last match); that emission updates the earlier row, the last
one winning, as the offline engine's join does. (The JAX package's online
engine appends it as a row of the current frame, without its image id.)
"""
from __future__ import annotations

import logging

import pandas as pd

from tracklab_torch.engine.engine import TrackingEngine, merge_dataframes

log = logging.getLogger(__name__)

__all__ = ["VideoOnlineTrackingEngine"]


class VideoOnlineTrackingEngine(TrackingEngine):
    def __init__(self, *args, target_fps: int = -1, **kwargs):
        super().__init__(*args, **kwargs)
        self.target_fps = target_fps

    def video_loop(self, video_metadata: pd.Series, video_id):
        import cv2
        source = video_metadata.get("file_path", video_metadata.get("name"))
        try:
            source = int(source)  # a webcam index
        except (TypeError, ValueError):
            source = str(source)
        cap = cv2.VideoCapture(source)
        if not cap.isOpened():
            raise FileNotFoundError(f"Cannot open video source {source}")
        try:
            return self._track_capture(cap, source, video_id)
        finally:
            cap.release()

    def _track_capture(self, cap, source, video_id):
        import cv2
        fps = cap.get(cv2.CAP_PROP_FPS) or 30
        frame_modulo = 1
        if 0 < self.target_fps < fps:
            frame_modulo = int(round(fps / self.target_fps))
        for model in self.models.values():
            if hasattr(model, "reset"):
                model.reset()

        frames_dets, image_rows, late = [], [], []
        frame_idx = -1
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frame_idx += 1
            if frame_idx % frame_modulo:
                continue
            image = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            image_id = f"{video_id}_{frame_idx}"
            metadata = pd.Series(dict(
                video_id=video_id, frame=frame_idx + 1,
                file_path=(f"cam://{source}" if isinstance(source, int)
                           else f"vid://{source}:{frame_idx}")),
                name=image_id)
            self.fire("on_image_loop_start", image_metadata=metadata,
                      image_idx=image_id, index=frame_idx)
            dets = pd.DataFrame()
            for name in self.module_names:
                dets, metadata = self._frame_step(self.models[name], image,
                                                  dets, metadata, late)
            image_rows.append(metadata)
            self.fire("on_image_loop_end", image_metadata=metadata,
                      image=image, image_idx=image_id, detections=dets)
            if len(dets):
                frames_dets.append(dets)
        detections = pd.concat(frames_dets) if frames_dets else \
            pd.DataFrame()
        for out in late:
            detections = merge_dataframes(detections, out)
        return detections, pd.DataFrame(image_rows)

    @staticmethod
    def _frame_step(model, image, dets, metadata, late):
        """One module on one frame; returns the frame's rows and its image
        row, each with the module's outputs merged in. Output rows of
        earlier frames go to ``late``."""
        if model.level == "image":
            batch = model.collate_fn([model.preprocess(
                image=image, detections=dets, metadata=metadata)])
            outs = [model.process(batch, dets, pd.DataFrame([metadata]))]
        elif model.level == "detection":
            bs = max(int(getattr(model, "batch_size", 1)), 1)
            outs = []
            for i in range(0, len(dets), bs):
                rows = dets.iloc[i:i + bs]
                batch = model.collate_fn([model.preprocess(
                    image=image, detection=det, metadata=metadata)
                    for _, det in rows.iterrows()])
                outs.append(model.process(batch, rows,
                                          pd.DataFrame([metadata])))
        elif hasattr(model, "process_online"):
            out = model.process_online(dets, metadata)
            here = out.index.isin(dets.index)
            if not here.all():
                late.append(out[~here])
            outs = [out[here]]
        else:
            raise ValueError(f"Module {model.name} (level={model.level}) "
                             "does not support online tracking")
        for out in outs:
            if isinstance(out, tuple):    # (detection rows, image rows)
                out, image_out = out
                metadata = merge_dataframes(pd.DataFrame([metadata]),
                                            image_out).iloc[0]
            dets = merge_dataframes(dets, out)
        return dets, metadata
