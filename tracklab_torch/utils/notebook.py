"""Python entry point beside the command line (counterpart of
tracklab_tpu.utils.notebook)."""
from __future__ import annotations

from collections import namedtuple

__all__ = ["load_from_overrides"]

TrackEngine = namedtuple(
    "TrackEngine",
    ["engine", "tracker_state", "pipeline", "dataset", "evaluator", "cfg"])


def load_from_overrides(overrides=None) -> TrackEngine:
    """Compose the config from command-line style ``overrides`` and build
    the dataset, modules and engine on the config's device, without
    running them.

    >>> te = load_from_overrides(["dataset=synthetic", "device=cpu"])
    >>> te.engine.track_dataset()
    """
    from tracklab_torch.config import compose
    from tracklab_torch.main import CONFIG_DIR, build, init_environment
    cfg = compose(CONFIG_DIR, "config", list(overrides or []))
    parts = build(cfg, init_environment(cfg))
    return TrackEngine(parts["engine"], parts["tracker_state"],
                       parts["pipeline"], parts["dataset"],
                       parts["evaluator"], cfg)
