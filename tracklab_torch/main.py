"""The port's command line (counterpart of tracklab_tpu.main).

Compose the YAML config tree (``tracklab_torch/configs``), instantiate the
dataset, evaluator, modules and engine from their ``_target_`` nodes on one
device, track the evaluation set, evaluate it and save the tracker state.

Usage:
  tracklab-torch [group=option ...] [a.b.c=value ...] [+a.b=value ...]
  e.g. tracklab-torch dataset=synthetic \\
         "state.load_from_groundtruth={detection: [bbox_ltwh, bbox_conf, category_id]}"

The top-level ``device`` key (``cuda`` by default) is resolved once: on a
machine without a card ``cuda`` raises, and ``device=cpu`` runs the plain
PyTorch path.
"""
from __future__ import annotations

import logging
import sys
from pathlib import Path

log = logging.getLogger(__name__)

CONFIG_DIR = Path(__file__).parent / "configs"


def init_environment(cfg):
    """Run directory, logging, and the run's device (resolved once)."""
    from tracklab_torch.device import resolve_device
    if cfg.get("use_run_dir", False):
        import datetime
        import os
        now = datetime.datetime.now()
        run_dir = (Path(cfg.get("output_dir", "outputs"))
                   / str(cfg.get("experiment_name", "run"))
                   / now.strftime("%Y-%m-%d") / now.strftime("%H-%M-%S"))
        run_dir.mkdir(parents=True, exist_ok=True)
        os.chdir(run_dir)
        log.info("Run dir: %s", run_dir)
    handlers = None
    if cfg.get("use_rich", True):
        try:
            from rich.logging import RichHandler
            handlers = [RichHandler(rich_tracebacks=True)]
        except ImportError:
            pass
    logging.basicConfig(level=logging.DEBUG if cfg.get("verbose")
                        else logging.INFO, handlers=handlers,
                        format="%(name)s: %(message)s")
    device = resolve_device(cfg.get("device", "cuda"))
    log.info("Device: %s", device)
    return device


def build(cfg, device):
    """Instantiate everything the run needs, the modules and the engine on
    ``device``; returns a dict of the parts."""
    from tracklab_torch.config import instantiate
    from tracklab_torch.datastruct.tracker_state import TrackerState
    from tracklab_torch.pipeline.module import Pipeline

    dataset = instantiate(cfg["dataset"])
    evaluator = instantiate(cfg["eval"]) if cfg.get("eval") else None
    modules = [instantiate(cfg["modules"][name], device=device)
               for name in cfg.get("pipeline", [])
               if name not in (None, "none", "skip")]
    pipeline = Pipeline(modules)
    tracking_set = dataset.sets[cfg.get("eval_set", "val")]
    tracker_state = TrackerState(tracking_set, pipeline,
                                 **dict(cfg.get("state", {})))
    callbacks = [instantiate(node)
                 for node in (cfg.get("callbacks") or {}).values()
                 if node is not None]
    # the visualization engine runs as a callback after the state is saved
    if cfg.get("visualization"):
        callbacks.append(instantiate(cfg["visualization"]))
    engine = instantiate(cfg["engine"], tracker_state=tracker_state,
                         modules=modules, callbacks=callbacks, device=device)
    return dict(dataset=dataset, evaluator=evaluator, pipeline=pipeline,
                tracker_state=tracker_state, engine=engine, modules=modules,
                callbacks=callbacks, device=device)


def evaluate(cfg, evaluator, tracker_state):
    """The evaluator's results, or None where there is nothing to hold the
    tracks against (a dataset without ground truth, such as a user's own
    video)."""
    if not (cfg.get("test_tracking", True) and evaluator is not None
            and len(tracker_state.video_metadatas)):
        return None
    if len(tracker_state.detections_gt) == 0:
        log.info("No ground truth in the evaluation set: not evaluated")
        return None
    return evaluator.run(tracker_state)


def run(cfg):
    device = init_environment(cfg)
    parts = build(cfg, device)
    if cfg.get("train_tracking", False):
        for module in parts["modules"]:
            if getattr(module, "training_enabled", False):
                module.train(parts["dataset"], parts["pipeline"],
                             parts["evaluator"], cfg.get("dataset"))
    if not cfg.get("test_tracking", True):
        return parts, None
    parts["engine"].track_dataset()
    return parts, evaluate(cfg, parts["evaluator"], parts["tracker_state"])


def main(argv=None):
    """Compose the config from ``argv`` (default: the command line) and
    run it; returns ``(parts, results)``."""
    from tracklab_torch.config import compose
    overrides = list(argv if argv is not None else sys.argv[1:])
    return run(compose(CONFIG_DIR, "config", overrides))


def cli(argv=None) -> int:
    """Console entry point: exit status 1 on failure."""
    try:
        main(argv)
    except Exception:
        log.exception("Run failed")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(cli())
