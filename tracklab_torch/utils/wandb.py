"""Weights & Biases adapter (counterpart of tracklab_tpu.utils.wandb).

Every call does nothing when ``wandb`` is not installed or its ``init``
failed, so a run never depends on it. The run is the module's, as in the
JAX package: :func:`init` opens it, :func:`log_metrics` writes its numeric
values, :func:`finish` closes it.
"""
from __future__ import annotations

import logging

log = logging.getLogger(__name__)

__all__ = ["init", "log_metrics", "finish", "apply_recursively"]

_run = None


def _wandb():
    try:
        import wandb
        return wandb
    except ImportError:
        return None


def apply_recursively(d, f, prefix=""):
    """Nested dicts -> one dict with dotted keys, ``f`` applied to each
    value."""
    out = {}
    for k, v in (d or {}).items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(apply_recursively(v, f, key))
        else:
            out[key] = f(v)
    return out


def init(cfg=None, project: str | None = None, name: str | None = None):
    global _run
    wandb = _wandb()
    if wandb is None:
        log.debug("wandb not installed; logging disabled")
        return None
    try:
        flat = apply_recursively(dict(cfg or {}), lambda v: v)
        _run = wandb.init(project=project or flat.get(
            "experiment_name", "tracklab-torch"), name=name, config=flat)
    except Exception as e:  # a logging backend must not stop the run
        log.warning("wandb.init failed: %s", e)
        _run = None
    return _run


def log_metrics(metrics: dict, prefix: str = ""):
    if _wandb() is None or _run is None:
        return
    flat = apply_recursively(metrics, lambda v: v, prefix)
    _run.log({k: v for k, v in flat.items() if isinstance(v, (int, float))})


def finish():
    global _run
    if _run is not None:
        _run.finish()
        _run = None
