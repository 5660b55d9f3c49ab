"""Callback hooks (counterpart of tracklab_tpu.callbacks.callback): the
engine calls them through a plain ordered registry, with the TrackerState
between the "before" and the "after" callbacks."""
from __future__ import annotations

__all__ = ["Callback"]


class Callback:
    after_saved_state = False

    def on_dataset_track_start(self, engine):
        pass

    def on_dataset_track_end(self, engine):
        pass

    def on_video_loop_start(self, engine, video_metadata, video_idx,
                            index):
        pass

    def on_video_loop_end(self, engine, video_metadata, video_idx,
                          detections, image_pred):
        pass

    def on_module_start(self, engine, task, dataloader):
        pass

    def on_module_end(self, engine, task, detections):
        pass

    def on_module_step_start(self, engine, task, batch):
        pass

    def on_module_step_end(self, engine, task, batch, detections):
        pass
