"""Weight conversion into the port's models (counterpart of the name maps
in tracklab_tpu.models.convert, kept as the port's own copy).

``yolox_from_flax`` takes a YOLOX ``{"params", "batch_stats"}`` tree (nested
dicts of numpy arrays, as the JAX package's ``model.init`` gives after
``np.asarray``) and returns the Megvii-layout state dict that
``models.yolox.YOLOX`` loads with ``strict=True``; ``kpr_from_flax`` does
the same for the KPR ``{"params", "batch_stats"}`` tree and
``models.kpr.KPR``.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["yolox_from_flax", "yolox_torch_key", "module_torch_key",
           "state_dict_from_flax", "kpr_from_flax", "kpr_torch_key"]

_LEAF_MAP = {"kernel": "weight", "scale": "weight", "bias": "bias",
             "mean": "running_mean", "var": "running_var"}
_PREFIX = {"backbone": ["backbone", "backbone"], "neck": ["backbone"],
           "head": ["head"]}


def yolox_torch_key(path) -> str:
    """Flax path (collection, top, *modules, leaf) -> Megvii key. The flax
    backbone/neck split maps onto torch's nested YOLOPAFPN: backbone/* ->
    backbone.backbone.*, neck/* -> backbone.*, head/* -> head.*; module
    names spell '.' as '__'."""
    coll, top, *rest = path
    return ".".join(_PREFIX[top] + [module_torch_key((coll, *rest))])


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def module_torch_key(path) -> str:
    """Flax path (collection, *modules, leaf) of a single module's tree ->
    its torch key, with the same '__' and leaf rules."""
    _, *mods, leaf = path
    comps = []
    for m in mods:
        comps.extend(m.split("__"))
    return ".".join(comps + [_LEAF_MAP[leaf]])


def state_dict_from_flax(variables, key_fn=module_torch_key) -> dict:
    """Flax variables -> torch state dict: conv kernels HWIO -> OIHW, BN
    scale/bias/mean/var -> weight/bias/running_mean/running_var, keys from
    ``key_fn`` (the default suits one module's own tree)."""
    out = {}
    for path, leaf in _flatten(variables):
        t = np.asarray(leaf, dtype=np.float32)
        if t.ndim == 4:
            t = t.transpose(3, 2, 0, 1)
        out[key_fn(path)] = torch.tensor(t)
    return out


def yolox_from_flax(variables) -> dict:
    """Flax YOLOX variables -> the Megvii-layout torch state dict."""
    return state_dict_from_flax(variables, yolox_torch_key)


_KPR_BARE = ("cls_token", "pos_embed", "sie_embed")


def kpr_torch_key(path) -> str:
    """Flax path (collection, *modules, leaf) of the KPR tree -> the port's
    key (the names of the JAX package's ``_kpr_torch_key``): module names
    spell '.' as '__'; the bare parameters cls_token, pos_embed and
    sie_embed keep their own names."""
    _, *mods, leaf = path
    comps = []
    for m in mods:
        comps.extend(m.split("__"))
    return ".".join(comps + [leaf if leaf in _KPR_BARE else _LEAF_MAP[leaf]])


def kpr_from_flax(variables) -> dict:
    """Flax KPR variables -> the state dict ``models.kpr.KPR`` loads with
    ``strict=True``: conv kernels HWIO -> OIHW, Dense kernels (in, out) ->
    Linear weights (out, in), bare parameters as they are."""
    out = {}
    for path, leaf in _flatten(variables):
        t = np.asarray(leaf, dtype=np.float32)
        if path[-1] == "kernel":
            t = t.transpose(3, 2, 0, 1) if t.ndim == 4 else t.T
        out[kpr_torch_key(path)] = torch.tensor(np.ascontiguousarray(t))
    return out
