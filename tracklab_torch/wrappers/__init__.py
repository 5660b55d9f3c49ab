"""Wrappers that adapt the port's trackers, models and datasets to the
Module contracts (counterpart of tracklab_tpu.wrappers)."""
