"""Hydra-shaped config composition without hydra (counterpart of
tracklab_tpu.config.compose, kept as the port's own copy).

Semantics the config tree uses:

  * a root config with a ``defaults:`` list composing config *groups*
    (``- dataset: synthetic`` loads ``configs/dataset/synthetic.yaml`` under
    the ``dataset`` key; ``- _self_`` sets the merge order);
  * CLI overrides: ``group=option`` re-selects a group file,
    ``a.b.c=value`` overrides a leaf, ``+a.b=value`` adds a leaf and
    ``+group=option`` adds a group's subtree, and ``+experiment=name``
    applies an experiment config (its defaults re-select groups, its body
    merges into the root);
  * ``${a.b}`` interpolation against the final merged tree;
  * ``_target_`` object instantiation (:func:`instantiate`).
"""
from __future__ import annotations

import copy
import functools
import importlib
import re
from pathlib import Path
from typing import Dict, List, Optional

import yaml

__all__ = ["OmegaDict", "load_yaml", "compose", "instantiate"]


class OmegaDict(dict):
    """dict with attribute access, recursive wrap and deep merge."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return OmegaDict({k: OmegaDict.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [OmegaDict.wrap(v) for v in obj]
        return obj

    def merge(self, other: dict):
        for k, v in other.items():
            if (k in self and isinstance(self[k], dict)
                    and isinstance(v, dict)):
                self[k].merge(v)
            else:
                self[k] = OmegaDict.wrap(v)
        return self

    def select(self, dotted: str, default=None):
        node = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_dotted(self, dotted: str, value):
        *parents, leaf = dotted.split(".")
        node = self
        for p in parents:
            if p not in node or not isinstance(node[p], dict):
                node[p] = OmegaDict()
            node = node[p]
        node[leaf] = OmegaDict.wrap(value)


def load_yaml(path) -> OmegaDict:
    with open(path) as fp:
        return OmegaDict.wrap(yaml.safe_load(fp) or {})


def _parse_value(text: str):
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


_INTERP = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def _resolve_node(node, root, stack=()):
    if isinstance(node, str):
        m = _INTERP.fullmatch(node)
        if m:  # a whole-string interpolation keeps the referent's type
            key = m.group(1)
            if key in stack:
                raise ValueError(f"Interpolation cycle at ${{{key}}}")
            return _resolve_node(root.select(key), root, stack + (key,))

        def sub(match):
            key = match.group(1)
            return str(_resolve_node(root.select(key), root, stack + (key,)))

        return _INTERP.sub(sub, node)
    if isinstance(node, dict):
        return OmegaDict({k: _resolve_node(v, root, stack)
                          for k, v in node.items()})
    if isinstance(node, list):
        return [_resolve_node(v, root, stack) for v in node]
    return node


def _search_dirs(config_dir: Path):
    from tracklab_torch.config.plugins import discover_plugin_config_dirs
    return [config_dir] + discover_plugin_config_dirs()


def _load_group(config_dir: Path, group: str, option: str,
                root_dir: Optional[Path] = None) -> OmegaDict:
    root_dir = root_dir or config_dir
    rel = group.replace(".", "/").replace("//", "/")
    group_dir = config_dir / rel
    path = group_dir / f"{option}.yaml"
    if not path.exists():
        # third-party plugin config packages (config/plugins.py)
        for alt in _search_dirs(root_dir)[1:]:
            if (alt / rel / f"{option}.yaml").exists():
                group_dir = alt / rel
                path = group_dir / f"{option}.yaml"
                break
    if not path.exists():
        raise FileNotFoundError(f"Config group file not found: {path}")
    cfg = load_yaml(path)
    # nested defaults inside group files: like Hydra, `/group` is
    # root-relative and a bare name is group-relative
    defaults = cfg.pop("defaults", None)
    if defaults:
        merged = OmegaDict()
        self_seen = False
        for entry in defaults:
            if entry == "_self_":
                merged.merge(cfg)
                self_seen = True
            elif isinstance(entry, dict):
                (g, opt), = entry.items()
                g = str(g)
                if g.startswith("/"):
                    sub = _load_group(root_dir, g[1:], str(opt), root_dir)
                    merged.set_dotted(g[1:], sub)
                else:
                    sub = _load_group(group_dir, g, str(opt), root_dir)
                    merged.set_dotted(g, sub)
        if not self_seen:
            merged.merge(cfg)
        cfg = merged
    return cfg


def compose(config_dir, config_name: str = "config",
            overrides: Optional[List[str]] = None) -> OmegaDict:
    """Compose the root config with its defaults list and CLI overrides."""
    config_dir = Path(config_dir)
    root_cfg = load_yaml(config_dir / f"{config_name}.yaml")
    defaults = root_cfg.pop("defaults", [])

    group_overrides: Dict[str, str] = {}
    value_overrides: List[tuple] = []
    experiment_bodies: List[OmegaDict] = []
    for ov in overrides or []:
        if ov.startswith("+"):
            key, _, val = ov[1:].partition("=")
            rel = key.replace(".", "/")
            candidate = config_dir / rel / f"{val}.yaml"
            if not candidate.exists():
                value_overrides.append((key, _parse_value(val)))
            elif rel.split("/")[0] == "experiment":
                # an experiment's defaults re-select whole groups; its body
                # merges into the root after _self_
                exp = load_yaml(candidate)
                for entry in exp.pop("defaults", []):
                    if isinstance(entry, dict):
                        (g, opt), = entry.items()
                        group_overrides[str(g).lstrip("/")] = str(opt)
                experiment_bodies.append(exp)
            else:
                # +group=option adds that group's subtree at its own path
                group_overrides[rel] = str(val)
            continue
        key, _, val = ov.partition("=")
        group_dir = config_dir / key.replace(".", "/")
        if (group_dir / f"{val}.yaml").exists():
            group_overrides[key] = str(val)
        elif group_dir.is_dir():
            options = sorted(p.stem for p in group_dir.glob("*.yaml"))
            raise FileNotFoundError(
                f"Unknown option '{val}' for config group '{key}'. "
                f"Available: {options}")
        else:
            value_overrides.append((key, _parse_value(val)))

    cfg = OmegaDict()
    self_seen = False
    for entry in defaults:
        if entry == "_self_":
            cfg.merge(root_cfg)
            self_seen = True
        elif isinstance(entry, dict):
            (group, option), = entry.items()
            option = group_overrides.pop(group, option)
            if option in (None, "null"):
                continue
            cfg.set_dotted(group.replace("/", "."),
                           _load_group(config_dir, group, str(option)))
    if not self_seen:
        cfg.merge(root_cfg)
    for group, option in group_overrides.items():
        cfg.set_dotted(group.replace("/", "."),
                       _load_group(config_dir, group, option))
    for body in experiment_bodies:
        _merge_experiment(cfg, body)
    for key, val in value_overrides:
        cfg.set_dotted(key, val)
    return _resolve_node(cfg, cfg)


def _merge_experiment(cfg: OmegaDict, body: OmegaDict):
    """An experiment's body over the composed tree: leaves set, a second
    level node with a ``_target_`` replaces its subtree, any other dict
    merges into the existing one."""
    for k, v in body.items():
        if not isinstance(v, dict):
            cfg.set_dotted(k, v)
            continue
        for k2, v2 in v.items():
            existing = cfg.select(f"{k}.{k2}")
            if isinstance(v2, dict) and "_target_" in v2:
                cfg.set_dotted(f"{k}.{k2}", OmegaDict.wrap(v2))
            elif isinstance(v2, dict) and isinstance(existing, dict):
                existing.merge(v2)
            else:
                cfg.set_dotted(f"{k}.{k2}", v2)


def instantiate(node, *args, **extra_kwargs):
    """Build the object a ``_target_`` node describes. Child ``_target_``
    nodes anywhere in a kwarg's containers are built first;
    ``_partial_: true`` returns a functools.partial."""
    if node is None:
        return None
    if not isinstance(node, dict) or "_target_" not in node:
        raise ValueError(f"Cannot instantiate non-target node: {node!r}")
    node = copy.deepcopy(node)
    target = node.pop("_target_")
    partial = node.pop("_partial_", False)
    node.pop("_recursive_", None)

    def build(v):
        if isinstance(v, dict) and "_target_" in v:
            return instantiate(v)
        if isinstance(v, dict):
            return {k2: build(v2) for k2, v2 in v.items()}
        if isinstance(v, list):
            return [build(v2) for v2 in v]
        return v

    kwargs = {k: build(v) for k, v in node.items()}
    kwargs.update(extra_kwargs)
    module_name, _, attr = target.rpartition(".")
    fn = getattr(importlib.import_module(module_name), attr)
    if partial:
        return functools.partial(fn, *args, **kwargs)
    return fn(*args, **kwargs)
