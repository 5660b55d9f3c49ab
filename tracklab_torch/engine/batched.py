"""Batched offline engine: track many videos at once (counterpart of
tracklab_tpu.engine.batched; BASELINE config 5, 8 videos at once).

Videos are taken in batches of ``video_batch_size``. Per video, the image-
and detection-level modules run up to the first video-level module (host
decode and the detector, as in the offline engine); then each video-level
module takes the whole batch: a tracker steps the V videos together over
a leading video axis (``process_video_batch``), a module without that mode
runs ``process`` per video; then each video is saved and its callbacks
fire.
"""
from __future__ import annotations

from tracklab_torch.engine.engine import merge_dataframes
from tracklab_torch.engine.offline import OfflineTrackingEngine

__all__ = ["BatchedOfflineTrackingEngine"]


class BatchedOfflineTrackingEngine(OfflineTrackingEngine):
    def __init__(self, *args, video_batch_size: int = 8,
                 use_mesh: bool = False, **kwargs):
        if use_mesh:
            raise NotImplementedError(
                "BatchedOfflineTrackingEngine(use_mesh=True): the multi-card "
                "video mesh is not ported to tracklab_torch yet (ROADMAP "
                "item 5: batched and multi-device); the port steps the "
                "videos on one card")
        super().__init__(*args, **kwargs)
        self.video_batch_size = max(int(video_batch_size), 1)

    def track_dataset(self):
        self.fire("on_dataset_track_start")
        videos = list(self.video_metadatas.iterrows())
        bs = self.video_batch_size
        for start in range(0, len(videos), bs):
            self._track_batch(videos[start:start + bs], start)
        self.fire("on_dataset_track_end")

    def _track_batch(self, chunk, start_index):
        state = self.tracker_state
        per_video = []
        # phase 1: per video, the modules before the first video-level one
        for i, (video_id, video_metadata) in enumerate(chunk):
            with state(video_id):
                self.fire("on_video_loop_start",
                          video_metadata=video_metadata,
                          video_idx=video_id, index=start_index + i)
                for model in self.models.values():
                    if hasattr(model, "reset"):
                        model.reset()
                detections, image_pred = state.load()
                for name in self.module_names:
                    if self.models[name].level == "video":
                        break
                    loader = self._loader(name, detections, image_pred)
                    self.fire("on_module_start", task=name,
                              dataloader=loader)
                    for batch in loader:
                        detections, image_pred = self.default_step(
                            batch, name, detections, image_pred)
                    self.fire("on_module_end", task=name,
                              detections=detections)
            per_video.append([video_id, video_metadata, detections,
                              image_pred])

        # phase 2: each video-level module over the whole batch
        for name in self.module_names:
            model = self.models[name]
            if model.level != "video":
                continue
            if hasattr(model, "process_video_batch"):
                outs = model.process_video_batch(
                    [(d, im) for _, _, d, im in per_video])
            else:
                outs = [model.process(d, im) for _, _, d, im in per_video]
            for rec, out in zip(per_video, outs):
                rec[2] = merge_dataframes(rec[2], out)

        # phase 3: save and callbacks per video
        for video_id, video_metadata, detections, image_pred in per_video:
            with state(video_id):
                self.fire("on_video_loop_end",
                          video_metadata=video_metadata,
                          video_idx=video_id, detections=detections,
                          image_pred=image_pred)
