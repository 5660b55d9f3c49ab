"""Collate for the engine's loader: stack numpy leaves, pass
``Unbatchable`` fields through as lists (counterpart of
tracklab_tpu.utils.collate)."""
from __future__ import annotations

import numpy as np

__all__ = ["Unbatchable", "default_collate"]


class Unbatchable:
    """Wrap a sample field to keep it as a list instead of stacking."""

    def __init__(self, value):
        self.value = value


def default_collate(batch):
    """Collate a list of samples: dict -> dict of collated values; numpy
    arrays of one shape -> a stacked array; scalars -> an array;
    Unbatchable -> the list of wrapped values; anything else -> a list."""
    if len(batch) == 0:
        return batch
    elem = batch[0]
    if isinstance(elem, Unbatchable):
        return [b.value for b in batch]
    if isinstance(elem, dict):
        return {k: default_collate([b[k] for b in batch]) for k in elem}
    if isinstance(elem, (tuple, list)):
        return type(elem)(default_collate(list(vals))
                          for vals in zip(*batch))
    if isinstance(elem, np.ndarray):
        if len({b.shape for b in batch}) == 1:
            return np.stack(batch)
        return list(batch)
    if isinstance(elem, (int, float, np.integer, np.floating)):
        return np.asarray(batch)
    return list(batch)
