"""Progress bars (counterpart of tracklab_tpu.callbacks.progress):
``Progressbar(use_rich=False)``, what config.yaml selects, is a tqdm bar
over videos and module batches; ``use_rich=True`` a rich bar over videos."""
from __future__ import annotations

from tracklab_torch.callbacks.callback import Callback

__all__ = ["Progressbar"]


class Progressbar(Callback):
    def __new__(cls, use_rich: bool = False, **kwargs):
        if cls is Progressbar:
            return super().__new__(
                RichProgressbar if use_rich else TQDMProgressbar)
        return super().__new__(cls)

    def __init__(self, use_rich: bool = False, **kwargs):
        pass


class TQDMProgressbar(Progressbar):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.video_pbar = None
        self.module_pbar = None

    def on_dataset_track_start(self, engine):
        from tqdm import tqdm
        self.video_pbar = tqdm(total=len(engine.video_metadatas),
                               desc="Videos", unit="video")

    def on_dataset_track_end(self, engine):
        if self.video_pbar is not None:
            self.video_pbar.close()
            self.video_pbar = None

    def on_video_loop_start(self, engine, video_metadata, video_idx, index):
        if self.video_pbar is not None:
            self.video_pbar.set_postfix_str(str(video_metadata.get(
                "name", video_idx)))

    def on_video_loop_end(self, engine, video_metadata, video_idx,
                          detections, image_pred):
        if self.video_pbar is not None:
            self.video_pbar.update(1)

    def on_module_start(self, engine, task, dataloader):
        from tqdm import tqdm
        self.module_pbar = tqdm(total=len(dataloader), desc=task,
                                unit="batch", leave=False)

    def on_module_end(self, engine, task, detections):
        if self.module_pbar is not None:
            self.module_pbar.close()
            self.module_pbar = None

    def on_module_step_end(self, engine, task, batch, detections):
        if self.module_pbar is not None:
            self.module_pbar.update(1)


class RichProgressbar(Progressbar):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.progress = None
        self.video_task = None

    def on_dataset_track_start(self, engine):
        import rich.progress
        self.progress = rich.progress.Progress(
            *rich.progress.Progress.get_default_columns(),
            rich.progress.MofNCompleteColumn(), speed_estimate_period=600)
        self.progress.start()
        self.video_task = self.progress.add_task(
            "[green]Videos", total=len(engine.video_metadatas))

    def on_dataset_track_end(self, engine):
        if self.progress is not None:
            self.progress.stop()
            self.progress = None

    def on_video_loop_end(self, engine, video_metadata, video_idx,
                          detections, image_pred):
        if self.progress is not None:
            self.progress.advance(self.video_task)
