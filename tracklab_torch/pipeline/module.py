"""Module / Pipeline contracts (counterpart of
tracklab_tpu.pipeline.module).

A Module declares its granularity *level* (image or video), the
columns it consumes (``input_columns``) and produces (``output_columns``);
a Pipeline checks the column flow before anything runs, so a misconfigured
run fails at once.
"""
from __future__ import annotations

import logging
import re
from abc import ABCMeta
from typing import Dict, List, Set

log = logging.getLogger(__name__)

__all__ = ["Module", "Pipeline", "Skip", "MetaModule"]


def _level_of(class_name: str) -> str:
    """``ImageLevelModule`` -> "image"."""
    return re.sub("([a-z0-9])([A-Z])", r"\1_\2",
                  class_name).lower().split("_")[0]


class MetaModule(ABCMeta):
    @property
    def name(cls):
        return cls.__name__

    @property
    def level(cls):
        return _level_of(cls.__bases__[0].__name__)


class Module(metaclass=MetaModule):
    input_columns = None
    output_columns = None
    training_enabled = False

    @property
    def name(self):
        return self.__class__.__name__

    @property
    def level(self):
        # the first *LevelModule class on the MRO, so helper bases between
        # a wrapper and its level class do not change the level
        for klass in type(self).__mro__:
            if klass.__name__.endswith("LevelModule"):
                return _level_of(klass.__name__)
        return _level_of(self.__class__.__bases__[0].__name__)

    def get_input_columns(self, level: str) -> List[str]:
        return self._columns(self.input_columns, level)

    def get_output_columns(self, level: str) -> List[str]:
        return self._columns(self.output_columns, level)

    @staticmethod
    def _columns(columns, level):
        if isinstance(columns, list):
            return columns if level == "detection" else []
        if isinstance(columns, dict):
            return columns.get(level, [])
        return []

    def train(self, *args, **kwargs):  # overridden by trainable modules
        raise NotImplementedError


class Pipeline:
    """Ordered module list with a symbolic check of the column flow."""

    def __init__(self, models: List[Module]):
        self.models = [m for m in models if m.name != "skip"]
        log.info("Pipeline: %s", self)

    def validate(self, load_columns: Dict[str, Set[str]]):
        columns = {k: set(v) for k, v in load_columns.items()}
        for level in ("image", "detection"):
            columns.setdefault(level, set())
            for model in self.models:
                if model.input_columns is None or \
                        model.output_columns is None:
                    raise AttributeError(
                        f"{type(model)} must declare input_ and "
                        "output_columns")
                needed = set(model.get_input_columns(level))
                if not needed.issubset(columns[level]):
                    raise AttributeError(
                        f"The {model.name} module is missing inputs: "
                        f"needed {sorted(needed)}, provided "
                        f"{sorted(columns[level])}")
                columns[level].update(model.get_output_columns(level))
        log.info("Pipeline has been validated")

    def __str__(self):
        return " -> ".join(m.name for m in self.models)

    def __len__(self):
        return len(self.models)

    def __iter__(self):
        return iter(self.models)


class Skip(Module):
    def __init__(self, **kwargs):
        pass

    @property
    def name(self):
        return "skip"
