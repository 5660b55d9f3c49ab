"""Offline engine: per video, each module runs over the whole video
(counterpart of tracklab_tpu.engine.offline).

Video-level modules (the scan trackers) take the whole video's detections
at once. With ``fused=True`` a detector -> tracker prefix whose modules
support it runs as one device program per video
(``engine/fused.py:run_fused_video``) and emits the same DataFrames as the
staged run. The JAX engine's 3- and 4-module fused branches (ReID, pose,
parts) wait for their wrappers in the port.
"""
from __future__ import annotations

import pandas as pd

from tracklab_torch.engine.engine import TrackingEngine, merge_dataframes

__all__ = ["OfflineTrackingEngine"]


class OfflineTrackingEngine(TrackingEngine):
    def _loader(self, name, detections, image_pred):
        self.datapipes[name].update(dict(image_pred["file_path"].items()),
                                    image_pred, detections)
        return self.dataloaders[name]

    def video_loop(self, video_metadata: pd.Series, video_id):
        detections, image_pred = self.tracker_state.load()
        model_names = list(self.module_names)
        if self.fused and len(model_names) >= 2 and len(detections) == 0:
            det_name, trk_name = model_names[:2]
            det_m, trk_m = self.models[det_name], self.models[trk_name]
            if (getattr(det_m, "supports_fused_detect", False)
                    and getattr(trk_m, "supports_fused_track", False)):
                # detector -> NMS -> tracker as one device program
                from tracklab_torch.engine.fused import run_fused_video
                loader = self._loader(det_name, detections, image_pred)
                self.fire("on_module_start", task=det_name,
                          dataloader=loader)
                det_df, trk_df = run_fused_video(det_m, trk_m, loader,
                                                 image_pred)
                detections = merge_dataframes(detections, det_df)
                self.fire("on_module_end", task=det_name,
                          detections=detections)
                self.fire("on_module_start", task=trk_name, dataloader=[])
                detections = merge_dataframes(detections, trk_df)
                self.fire("on_module_end", task=trk_name,
                          detections=detections)
                model_names = model_names[2:]
                if len(detections) == 0:
                    return detections, image_pred
        for model_name in model_names:
            model = self.models[model_name]
            if model.level == "video":
                self.fire("on_module_start", task=model_name, dataloader=[])
                outputs = model.process(detections, image_pred)
                detections = merge_dataframes(detections, outputs)
            else:
                loader = self._loader(model_name, detections, image_pred)
                self.fire("on_module_start", task=model_name,
                          dataloader=loader)
                for batch in loader:
                    detections, image_pred = self.default_step(
                        batch, model_name, detections, image_pred)
            self.fire("on_module_end", task=model_name,
                      detections=detections)
            if len(detections) == 0:
                return detections, image_pred
        return detections, image_pred
