"""A torch.profiler trace of ``track_dataset`` behind one flag (counterpart
of tracklab_tpu.callbacks.profiler's JaxProfiler)."""
from __future__ import annotations

import logging
from pathlib import Path

from tracklab_torch.callbacks.callback import Callback

log = logging.getLogger(__name__)

__all__ = ["TorchProfiler"]


class TorchProfiler(Callback):
    """With ``enabled``, profiles the host and, on a CUDA engine, the card
    from ``on_dataset_track_start`` to ``on_dataset_track_end`` and writes
    a Chrome trace to ``trace_dir/trace.json`` (``trace_path``)."""

    def __init__(self, trace_dir: str = "torch_trace", enabled: bool = False,
                 **kwargs):
        self.trace_dir = Path(trace_dir)
        self.enabled = enabled
        self.trace_path = None
        self._prof = None

    def on_dataset_track_start(self, engine):
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if engine.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()

    def on_dataset_track_end(self, engine):
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self.trace_dir.mkdir(parents=True, exist_ok=True)
        self.trace_path = self.trace_dir / "trace.json"
        prof.export_chrome_trace(str(self.trace_path))
        log.info("torch.profiler trace -> %s", self.trace_path)
