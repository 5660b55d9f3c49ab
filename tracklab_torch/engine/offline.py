"""Offline engine: per video, each module runs over the whole video
(counterpart of tracklab_tpu.engine.offline).

Video-level modules (the scan trackers) take the whole video's detections
at once. With ``fused=True`` a fusable prefix runs as one device program
per video and emits the same DataFrames as the staged run: detector ->
top-down pose -> prompted KPR -> BPBReID (``engine/fused.py:
run_fused_gsr_video``), detector -> ReID -> embedding tracker
(``run_fused_reid_video``), detector -> top-down pose -> tracker
(``run_fused_pose_video``), detector -> promptless KPR -> BPBReID
(``run_fused_parts_video``), detector -> tracker (``run_fused_video``) or
bottom-up pose -> tracker (``run_fused_bottomup_video``). The longest
fusable prefix is taken first.
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

    def _fused_prefix(self, run_fused, names, detections, image_pred):
        """Run the modules ``names`` as one device program and merge each
        one's DataFrame in pipeline order, firing its module hooks."""
        loader = self._loader(names[0], detections, image_pred)
        self.fire("on_module_start", task=names[0], dataloader=loader)
        dfs = run_fused(*(self.models[n] for n in names), loader,
                        image_pred)
        for i, (name, df) in enumerate(zip(names, dfs)):
            if i:
                self.fire("on_module_start", task=name, dataloader=[])
            detections = merge_dataframes(detections, df)
            self.fire("on_module_end", task=name, detections=detections)
        return detections

    @staticmethod
    def _fused_4(det_m, pose_m, reid_m, trk_m):
        """The fused runner of a 4-module prefix, or None: detector -> NMS
        -> device crops -> top-down pose -> KPR prompted by the pose ->
        BPBReID."""
        from tracklab_torch.engine import fused as FU
        if (getattr(det_m, "supports_fused_detect", False)
                and getattr(pose_m, "supports_fused_pose", False)
                and getattr(reid_m, "supports_fused_prompted_parts", False)
                and getattr(trk_m, "supports_fused_parts_track", False)):
            return FU.run_fused_gsr_video
        return None

    @staticmethod
    def _fused_3(det_m, mid_m, trk_m):
        """The fused runner of a 3-module prefix, or None: detector -> NMS
        -> device crops -> ReID -> embedding tracker, detector -> NMS ->
        device crops -> top-down pose -> tracker, or detector -> NMS ->
        device crops -> promptless KPR -> BPBReID."""
        from tracklab_torch.engine import fused as FU
        if not getattr(det_m, "supports_fused_detect", False):
            return None
        if (getattr(mid_m, "supports_fused_embed", False)
                and getattr(trk_m, "supports_fused_emb_track", False)):
            return FU.run_fused_reid_video
        if (getattr(mid_m, "supports_fused_pose", False)
                and getattr(trk_m, "supports_fused_track", False)):
            return FU.run_fused_pose_video
        if (getattr(mid_m, "supports_fused_parts", False)
                and getattr(trk_m, "supports_fused_parts_track", False)):
            return FU.run_fused_parts_video
        return None

    def video_loop(self, video_metadata: pd.Series, video_id):
        for model in self.models.values():
            if hasattr(model, "reset"):
                model.reset()
        detections, image_pred = self.tracker_state.load()
        model_names = list(self.module_names)
        for n, pick in ((4, self._fused_4), (3, self._fused_3)):
            if not (self.fused and len(model_names) >= n
                    and len(detections) == 0):
                continue
            run_fused = pick(*(self.models[m] for m in model_names[:n]))
            if run_fused is not None:
                detections = self._fused_prefix(
                    run_fused, model_names[:n], detections, image_pred)
                model_names = model_names[n:]
                if len(detections) == 0 or not model_names:
                    return detections, image_pred
        if self.fused and len(model_names) >= 2 and len(detections) == 0:
            det_name, trk_name = model_names[:2]
            det_m, trk_m = self.models[det_name], self.models[trk_name]
            run_fused = None
            if getattr(trk_m, "supports_fused_track", False):
                from tracklab_torch.engine import fused as FU
                if getattr(det_m, "supports_fused_detect", False):
                    # detector -> NMS -> tracker as one device program
                    run_fused = FU.run_fused_video
                elif getattr(det_m, "supports_fused_bottomup", False):
                    # bottom-up pose (boxes from keypoints) -> tracker
                    run_fused = FU.run_fused_bottomup_video
            if run_fused is not None:
                detections = self._fused_prefix(
                    run_fused, [det_name, trk_name], detections,
                    image_pred)
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
