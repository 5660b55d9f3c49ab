"""Weight conversion into the port's models (counterpart of the name maps
in tracklab_tpu.models.convert, kept as the port's own copy).

``yolox_from_flax`` takes a YOLOX ``{"params", "batch_stats"}`` tree (nested
dicts of numpy arrays, as the JAX package's ``model.init`` gives after
``np.asarray``) and returns the Megvii-layout state dict that
``models.yolox.YOLOX`` loads with ``strict=True``; ``kpr_from_flax`` does
the same for the KPR ``{"params", "batch_stats"}`` tree and
``models.kpr.KPR``. ``osnet_from_flax`` builds a ``models.osnet.OSNet``
from the JAX package's OSNet tree, and ``convert_osnet_torch`` loads a
torchreid OSNet state dict (the name map of the JAX package's
``convert_osnet_torch``, kept as the port's own copy).
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from tracklab_torch.device import resolve_device

__all__ = ["yolox_from_flax", "yolox_torch_key", "module_torch_key",
           "state_dict_from_flax", "kpr_from_flax", "kpr_torch_key",
           "osnet_from_flax", "osnet_torch_key", "convert_osnet_torch"]

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


def osnet_torch_key(path):
    """Flax path (collection, *modules, leaf) of the JAX package's OSNet ->
    the torchreid state-dict key (its ``_osnet_torch_key``): module names
    spell '.' as '__' (conv2__0/conv2b__1/conv1/kernel ->
    conv2.0.conv2b.1.conv1.weight); None for the first-party part head
    ``part_fc``, which no torchreid checkpoint holds."""
    if len(path) > 1 and path[1] == "part_fc":
        return None
    return module_torch_key(path)


def _osnet_state_dict(variables) -> dict:
    """Flax OSNet variables -> the port's state dict: conv kernels HWIO ->
    OIHW (the depthwise (3, 3, 1, C) -> (C, 1, 3, 3) alike), Dense kernels
    (in, out) -> Linear weights (out, in)."""
    out = {}
    for path, leaf in _flatten(variables):
        t = np.asarray(leaf, dtype=np.float32)
        if path[-1] == "kernel":
            t = t.transpose(3, 2, 0, 1) if t.ndim == 4 else t.T
        out[module_torch_key(path)] = torch.tensor(np.ascontiguousarray(t))
    return out


def osnet_from_flax(variables, n_parts: int = 6, dtype=torch.float32,
                    device=None):
    """Build a ``models.osnet.OSNet`` from the JAX package's OSNet
    ``{"params", "batch_stats"}`` tree (numpy arrays): the variant from the
    stem's width, ``ibn`` from the stem's norm (InstanceNorm has no batch
    statistics), ``feat_dim`` from the head. ``n_parts`` is the JAX model's
    (the part head's weights do not show it). Loads with ``strict=True``
    and returns the model on ``device`` (``cuda`` unless told otherwise)."""
    from tracklab_torch.models.osnet import OSNET_VARIANTS, OSNet

    params = variables["params"]
    stem = np.asarray(params["conv1"]["conv"]["kernel"]).shape[-1]
    variant = next(k for k, v in OSNET_VARIANTS.items()
                   if v["channels"][0] == stem)
    ibn = "bn" not in variables.get("batch_stats", {}).get("conv1", {})
    feat_dim = np.asarray(params["fc__0"]["kernel"]).shape[1]
    model = OSNet(variant, feat_dim, n_parts, ibn=ibn, dtype=dtype,
                  device="cpu")
    model.load_state_dict(_osnet_state_dict(variables), strict=True)
    return model.to(resolve_device(device))


def convert_osnet_torch(state_dict, model):
    """Load a torchreid OSNet state dict (osnet_x1_0 family, the ibn
    variant included; tensors or numpy arrays) into ``model`` (an
    ``OSNet`` of the same variant) and return it. A ``module.`` prefix is
    dropped, as are ``classifier.*`` and ``num_batches_tracked``; the part
    head keeps the model's own weights. Raises on any other missing or
    unused tensor, or a shape mismatch."""
    sd = {}
    for k, v in state_dict.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if k.startswith("classifier.") or k.endswith("num_batches_tracked"):
            continue
        sd[k] = torch.as_tensor(np.asarray(v, dtype=np.float32))
    own = model.state_dict()
    missing = [k for k in own if k not in sd and not k.startswith("part_fc.")]
    unused = [k for k in sd if k not in own]
    bad = [k for k in sd if k in own and sd[k].shape != own[k].shape]
    if missing or unused or bad:
        raise ValueError(f"torchreid OSNet state dict does not fit: missing "
                         f"{missing[:10]}, unused {unused[:10]}, shape "
                         f"mismatch {bad[:10]}")
    model.load_state_dict(sd, strict=False)
    return model
