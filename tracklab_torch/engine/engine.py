"""Tracking engine base: the per-video loop and callback dispatch
(counterpart of tracklab_tpu.engine.engine)."""
from __future__ import annotations

import logging
from abc import abstractmethod
from typing import Dict, List

import numpy as np
import pandas as pd

from tracklab_torch.callbacks.callback import Callback
from tracklab_torch.datastruct.datapipe import EngineDatapipe, PrefetchLoader
from tracklab_torch.datastruct.tracker_state import TrackerState
from tracklab_torch.device import resolve_device

log = logging.getLogger(__name__)

__all__ = ["TrackingEngine", "merge_dataframes"]


def merge_dataframes(main_df: pd.DataFrame, appended_piece):
    """Merge a module's output rows and columns (a DataFrame, a Series of
    one row, or a list of either) into the running frame: new columns and
    new rows are appended, existing cells are overridden by the new
    values."""
    if isinstance(appended_piece, pd.Series):
        appended_piece = appended_piece.to_frame().T
    elif isinstance(appended_piece, list):
        appended_piece = pd.concat(
            [p.to_frame().T if isinstance(p, pd.Series) else p
             for p in appended_piece]) if appended_piece else pd.DataFrame()
    if main_df is None or len(main_df) == 0:
        return appended_piece
    if len(appended_piece) == 0:
        return main_df
    main_df = main_df.copy()
    new_columns = appended_piece.columns.difference(main_df.columns)
    new_index = appended_piece.index.difference(main_df.index)
    if len(new_index):
        filler = pd.DataFrame(index=new_index, columns=main_df.columns)
        main_df = pd.concat([main_df, filler])
    # new columns are assigned whole (array cells keep object dtype);
    # overlapping columns are updated cell by cell
    for col in new_columns:
        main_df[col] = appended_piece[col].reindex(main_df.index)
    overlap = [c for c in appended_piece.columns if c not in new_columns]
    if overlap:
        main_df.update(appended_piece[overlap])
    return main_df


class TrackingEngine:
    """Base engine.

    Args:
      tracker_state: TrackerState
      modules: the pipeline's modules, in order
      callbacks: dict name -> Callback, or a list
      num_workers: host decode threads
      fused: run a fusable detector -> tracker prefix as one device program
        per video (``engine/fused.py``)
      device: the run's device (``cuda`` unless told otherwise)
    """

    def __init__(self, tracker_state: TrackerState, modules,
                 callbacks: Dict[str, Callback] | List[Callback] | None =
                 None, num_workers: int = 4, fused: bool = False,
                 device=None, **kwargs):
        self.tracker_state = tracker_state
        self.fused = fused
        self.device = resolve_device(device)
        self.module_names = [m.name for m in modules]
        self.models = {m.name: m for m in modules}
        self.num_workers = num_workers
        self.img_metadatas = tracker_state.image_metadatas
        self.video_metadatas = tracker_state.video_metadatas

        if isinstance(callbacks, dict):
            callbacks = list(callbacks.values())
        callbacks = callbacks or []
        before = [c for c in callbacks
                  if not getattr(c, "after_saved_state", False)]
        after = [c for c in callbacks
                 if getattr(c, "after_saved_state", False)]
        self.callbacks: List = before + [tracker_state] + after

        self.datapipes = {}
        self.dataloaders = {}
        for name, model in self.models.items():
            if model.level in ("image", "detection"):
                self.datapipes[name] = EngineDatapipe(
                    model, decode_workers=num_workers)
                self.dataloaders[name] = PrefetchLoader(
                    self.datapipes[name],
                    batch_size=getattr(model, "batch_size", 1),
                    collate_fn=model.collate_fn, num_workers=num_workers)

    def fire(self, hook: str, **kwargs):
        for cb in self.callbacks:
            fn = getattr(cb, hook, None)
            if fn is not None:
                fn(engine=self, **kwargs)

    def track_dataset(self):
        """The per-video loop."""
        self.fire("on_dataset_track_start")
        for i, (video_id, video_metadata) in enumerate(
                self.video_metadatas.iterrows()):
            with self.tracker_state(video_id):
                self.fire("on_video_loop_start",
                          video_metadata=video_metadata,
                          video_idx=video_id, index=i)
                detections, image_pred = self.video_loop(
                    video_metadata, video_id)
                self.fire("on_video_loop_end",
                          video_metadata=video_metadata,
                          video_idx=video_id, detections=detections,
                          image_pred=image_pred)
        self.fire("on_dataset_track_end")

    @abstractmethod
    def video_loop(self, video_metadata: pd.Series, video_id):
        ...

    def default_step(self, batch, task: str, detections: pd.DataFrame,
                     image_pred: pd.DataFrame, **kwargs):
        """One batch of an image- or detection-level module: select its
        rows, run ``process`` and merge the output back. A module may
        return ``(detection rows, image rows)``; the image rows (e.g. a
        camera warp per frame) are merged into ``image_pred``."""
        model = self.models[task]
        self.fire("on_module_step_start", task=task, batch=batch)
        ids, samples = batch
        if model.level == "image":
            batch_metadatas = image_pred.loc[np.asarray(ids)]
            batch_detections = detections[detections["image_id"].isin(
                batch_metadatas.index)] if len(detections) else detections
        else:
            batch_detections = detections.loc[np.asarray(ids)]
            batch_metadatas = image_pred.loc[
                batch_detections["image_id"].unique()]
        outputs = model.process(samples, batch_detections, batch_metadatas)
        if isinstance(outputs, tuple):
            outputs, image_outputs = outputs
            image_pred = merge_dataframes(image_pred, image_outputs)
        detections = merge_dataframes(detections, outputs)
        self.fire("on_module_step_end", task=task, batch=batch,
                  detections=detections)
        return detections, image_pred
