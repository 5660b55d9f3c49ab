"""Weight conversion into the port's models (counterpart of the name maps
in tracklab_tpu.models.convert, kept as the port's own copy).

``yolox_from_flax`` takes a YOLOX ``{"params", "batch_stats"}`` tree (nested
dicts of numpy arrays, as the JAX package's ``model.init`` gives after
``np.asarray``) and returns the Megvii-layout state dict that
``models.yolox.YOLOX`` loads with ``strict=True``; ``kpr_from_flax`` does
the same for the KPR ``{"params", "batch_stats"}`` tree and
``models.kpr.KPR``, and ``convert_kpr_torch`` loads a reference KPR
checkpoint (the authors' fork's key names, whose aliases it rewrites).
``osnet_from_flax`` builds a ``models.osnet.OSNet``
from the JAX package's OSNet tree, and ``convert_osnet_torch`` loads a
torchreid OSNet state dict (the name map of the JAX package's
``convert_osnet_torch``, kept as the port's own copy). ``yolov8_from_flax``
and ``yolo11_from_flax`` carry the JAX package's YOLOv8 / YOLO11 trees into
``models.yolov8.YOLOv8`` / ``models.yolo11.YOLO11``, and
``convert_yolov8_torch`` loads an ultralytics state dict into either.
The pose models: ``yoloxpose_from_flax``, ``topdownpose_from_flax`` and
``simccpose_from_flax`` carry the JAX package's ``YOLOXPose``,
``TopDownPose`` and ``SimCCPose`` trees into ``models.pose``,
``yolo11_from_flax`` also carries ``YOLO11Pose``, ``vitpose_from_flax``
carries ``ViTPose``, and ``convert_vitpose_torch`` loads an HF
``VitPoseForPoseEstimation`` state dict (the port's ViTPose holds its key
names). The detector zoo and DeepLabV3: ``rtmdet_from_flax``,
``rtdetr_from_flax``, ``rtdetr_hf_from_flax`` and ``deeplabv3_from_flax``
carry the JAX package's trees across; ``convert_rtmdet_torch`` (mmdet
keys), ``convert_rtdetr_hf_torch`` (HF keys) and
``convert_deeplabv3_torch`` (torchvision keys) load reference checkpoints.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from tracklab_torch.device import resolve_device

__all__ = ["yolox_from_flax", "yolox_torch_key", "module_torch_key",
           "state_dict_from_flax", "kpr_from_flax", "kpr_torch_key",
           "convert_kpr_torch",
           "osnet_from_flax", "osnet_torch_key", "convert_osnet_torch",
           "yolov8_from_flax", "yolo11_from_flax", "convert_yolov8_torch",
           "pitchsegnet_from_flax", "yoloxpose_from_flax",
           "topdownpose_from_flax", "simccpose_from_flax",
           "vitpose_from_flax", "convert_vitpose_torch",
           "rtmdet_from_flax", "convert_rtmdet_torch", "rtdetr_from_flax",
           "rtdetr_hf_from_flax", "convert_rtdetr_hf_torch",
           "deeplabv3_from_flax", "convert_deeplabv3_torch"]

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


def _load_checked(sd, model, what, unused_ok=()):
    """Load ``sd`` (tensors or numpy arrays; BN's ``num_batches_tracked``
    and keys starting with ``unused_ok`` dropped) into ``model`` strictly
    and return it; raises on any missing or unused tensor, or a shape
    mismatch."""
    sd = {k: torch.as_tensor(np.asarray(v, dtype=np.float32))
          for k, v in sd.items()
          if not k.endswith("num_batches_tracked")
          and not k.startswith(unused_ok)}
    own = model.state_dict()
    missing = [k for k in own if k not in sd]
    unused = [k for k in sd if k not in own]
    bad = [k for k in sd if k in own and sd[k].shape != own[k].shape]
    if missing or unused or bad:
        raise ValueError(f"{what} state dict does not fit: missing "
                         f"{missing[:10]}, unused {unused[:10]}, shape "
                         f"mismatch {bad[:10]}")
    model.load_state_dict(sd, strict=True)
    return model


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


# Other spellings of the same modules in the KPR / BPBReID fork lineage
# (the JAX package's ``_KPR_ALIASES``), rewritten before the names are
# matched
_KPR_ALIASES = (
    ("backbone_appearance_feature_extractor.", "backbone."),
    ("base.", "backbone."),
    ("global_identity_classifier.bn.", "bn_global."),
    ("foreground_identity_classifier.bn.", "bn_foreground."),
    ("concat_parts_identity_classifier.bn.", "bn_concat_parts."),
    ("parts_identity_classifier.bn.", "bn_parts."),
    ("global_after_pooling_dim_reduce.", "dim_reduce_global."),
    ("foreground_after_pooling_dim_reduce.", "dim_reduce_foreground."),
    ("parts_after_pooling_dim_reduce.", "dim_reduce_parts."),
    ("concat_parts_after_pooling_dim_reduce.",
     "dim_reduce_concat_parts."),
)
# training-only identity classifier heads, which inference does not use
_KPR_UNUSED = ("bn_global.classifier", "bn_foreground.classifier",
               "bn_concat_parts.classifier", "bn_parts.classifier",
               "classifier.", "global_identity_classifier.",
               "foreground_identity_classifier.",
               "concat_parts_identity_classifier.",
               "parts_identity_classifier.")


def convert_kpr_torch(state_dict, model):
    """Load a reference KPR state dict (tensors or numpy arrays) into
    ``model`` (a ``models.kpr.KPR`` of the same architecture) and return it:
    a ``module.`` prefix is dropped, the fork's aliases (``_KPR_ALIASES``)
    are rewritten, the identity classifier heads and ``num_batches_tracked``
    are dropped, and the rest loads strict (the port's keys are the
    checkpoint's). Raises on any missing or unused tensor, or a shape
    mismatch."""
    sd = {}
    for k, v in state_dict.items():
        k = k[len("module."):] if k.startswith("module.") else k
        for old, new in _KPR_ALIASES:
            if k.startswith(old):
                k = new + k[len(old):]
                break
        sd[k] = v
    return _load_checked(sd, model, "KPR", unused_ok=_KPR_UNUSED)


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
    statistics), ``feat_dim`` from the head, the input width from the
    stem's kernel (8 on the keypoint path). ``n_parts`` is the JAX model's
    (the part head's weights do not show it). Loads with ``strict=True``
    and returns the model on ``device`` (``cuda`` unless told otherwise)."""
    from tracklab_torch.models.osnet import OSNET_VARIANTS, OSNet

    params = variables["params"]
    _, _, in_channels, stem = np.asarray(
        params["conv1"]["conv"]["kernel"]).shape
    variant = next(k for k, v in OSNET_VARIANTS.items()
                   if v["channels"][0] == stem)
    ibn = "bn" not in variables.get("batch_stats", {}).get("conv1", {})
    feat_dim = np.asarray(params["fc__0"]["kernel"]).shape[1]
    model = OSNet(variant, feat_dim, n_parts, ibn=ibn,
                  in_channels=in_channels, dtype=dtype, device="cpu")
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


def yolov8_from_flax(variables) -> dict:
    """Flax YOLOv8 variables -> the ultralytics-named state dict that
    ``models.yolov8.YOLOv8`` loads with ``strict=True`` (the JAX package's
    ``_yolov8_torch_key``: module names spell '.' as '__'; depthwise
    kernels (3, 3, 1, C) become (C, 1, 3, 3))."""
    return state_dict_from_flax(variables)


# YOLO11's flax names follow the same ultralytics map
yolo11_from_flax = yolov8_from_flax


# the DFL projection: the fixed arange(reg_max) kernel, computed as math in
# decode_v8 (head index 22 in v8 checkpoints, 23 in yolo11)
_YOLO_UNUSED = ("model.22.dfl.", "model.23.dfl.")


def convert_yolov8_torch(state_dict, model):
    """Load an ultralytics YOLOv8 or YOLO11 state dict (tensors or numpy
    arrays) into ``model`` and return it. A ``model.model.`` prefix is
    stripped and a missing ``model.`` prefix added (the JAX package's
    ``convert_yolov8_torch``); the DFL projection and BN's
    ``num_batches_tracked`` are dropped. Raises on any other missing or
    unused tensor, or a shape mismatch."""
    sd = {(k[len("model.model."):] if k.startswith("model.model.") else k): v
          for k, v in state_dict.items()}
    if not any(k.startswith("model.") for k in sd):
        sd = {f"model.{k}": v for k, v in sd.items()}
    return _load_checked(sd, model, "ultralytics YOLO",
                         unused_ok=_YOLO_UNUSED)


# flax auto-names of PitchSegNet's submodules -> the port's attributes
_SEG_NAMES = {"CSPDarknet_0": "backbone", "ASPP_0": "aspp",
              "ConvBnAct_0": "low", "ConvBnAct_1": "fuse", "Conv_0": "cls"}
_ASPP_NAMES = {"ConvBnAct_0": "b0", "ConvBnAct_1": "pool",
               "ConvBnAct_2": "project"}


def _seg_key(path) -> str:
    coll, top, *rest = path
    if top == "ASPP_0" and rest[0] not in _ASPP_NAMES:
        kind, i = rest[0].rsplit("_", 1)        # Conv_i / BatchNorm_i
        rest = [f"atrous__{i}", "conv" if kind == "Conv" else "bn"] \
            + rest[1:]
    elif top == "ASPP_0":
        rest = [_ASPP_NAMES[rest[0]]] + rest[1:]
    return module_torch_key((coll, _SEG_NAMES[top], *rest))


def pitchsegnet_from_flax(variables) -> dict:
    """Flax PitchSegNet variables (the JAX package's
    ``models.segmentation.PitchSegNet``) -> the state dict that
    ``models.segmentation.PitchSegNet`` loads with ``strict=True``."""
    return state_dict_from_flax(variables, _seg_key)


def _deconv_weight(kernel):
    """A flax transposed-conv kernel (kh, kw, in, out), applied without a
    flip (``nn.ConvTranspose``, or the input-dilated conv of the JAX
    package's ViTPose), -> the ConvTranspose2d(k, s=2, p=1) weight (in, out,
    kh, kw) that computes the same map: spatially flipped
    (``models/pose.py``'s docstring derives it)."""
    return kernel[::-1, ::-1].transpose(2, 3, 0, 1)


def _pose_state_dict(variables, key_fn, is_deconv=lambda path: False):
    """Flax variables -> torch state dict: conv kernels HWIO -> OIHW, Dense
    kernels (in, out) -> (out, in), transposed-conv kernels (``is_deconv``)
    by :func:`_deconv_weight`; keys from ``key_fn``."""
    out = {}
    for path, leaf in _flatten(variables):
        t = np.asarray(leaf, dtype=np.float32)
        if path[-1] == "kernel":
            if is_deconv(path):
                t = _deconv_weight(t)
            else:
                t = t.transpose(3, 2, 0, 1) if t.ndim == 4 else t.T
        out[key_fn(path)] = torch.tensor(np.ascontiguousarray(t))
    return out


_POSE_HEAD = (("stems", "cls_convs", "reg_convs", "kp_convs"),
              ("cls_preds", "reg_preds", "obj_preds", "kp_preds"))


def _yoloxpose_key(path) -> str:
    """The JAX package's YOLOXPose names (flax auto-names) -> the port's:
    CSPDarknet_0 -> backbone.backbone, YOLOPAFPN_0 -> backbone, and per
    level i the head's ConvBnAct_{4i + j} (stem, cls, reg, kp branch) and
    Conv_{4i + j} (cls, reg, obj, kp prediction), in the flax module's call
    order."""
    coll, top, *rest = path
    if top == "CSPDarknet_0":
        prefix = ["backbone", "backbone"]
    elif top == "YOLOPAFPN_0":
        prefix = ["backbone"]
    else:
        kind, n = top.rsplit("_", 1)
        names = _POSE_HEAD[kind == "Conv"]
        prefix = ["head", names[int(n) % 4], str(int(n) // 4)]
    return ".".join(prefix + [module_torch_key((coll, *rest))])


def yoloxpose_from_flax(variables) -> dict:
    """Flax YOLOXPose variables -> the state dict ``models.pose.YOLOXPose``
    loads with ``strict=True``."""
    return _pose_state_dict(variables, _yoloxpose_key)


def _topdown_key(path) -> str:
    coll, top, *rest = path
    kind, _, n = top.rpartition("_")
    prefix = {"CSPDarknet": ["backbone"],
              "ConvTranspose": ["deconvs", n, "deconv"],
              "BatchNorm": ["deconvs", n, "bn"],
              "Conv": ["final"]}.get(kind, [top])
    return ".".join(prefix + [module_torch_key((coll, *rest))])


def topdownpose_from_flax(variables) -> dict:
    """Flax TopDownPose variables -> the state dict
    ``models.pose.TopDownPose`` loads with ``strict=True``; the
    ``nn.ConvTranspose`` kernels by :func:`_deconv_weight`."""
    return _pose_state_dict(variables, _topdown_key,
                            lambda path: path[1].startswith("ConvTranspose"))


def simccpose_from_flax(variables) -> dict:
    """Flax SimCCPose variables -> the state dict ``models.pose.SimCCPose``
    loads with ``strict=True``."""
    return _pose_state_dict(variables, _topdown_key)


def _vitpose_key(path) -> str:
    _, *mods, leaf = path
    if leaf == "position_embeddings":
        comps = []
        for m in mods:
            comps.extend(m.split("__"))
        return ".".join(comps + [leaf])
    return module_torch_key(path)


def vitpose_from_flax(variables) -> dict:
    """Flax ViTPose variables (the JAX package's, with HF names) -> the state
    dict ``models.vitpose.ViTPose`` loads with ``strict=True``; the decoder's
    input-dilated conv kernels become ConvTranspose2d weights by
    :func:`_deconv_weight`."""
    return _pose_state_dict(variables, _vitpose_key,
                            lambda path: path[-2].startswith("deconv"))


def convert_vitpose_torch(state_dict, model):
    """Load an HF ``VitPoseForPoseEstimation`` state dict (tensors or numpy
    arrays) into ``model`` (a ``models.vitpose.ViTPose`` of the same
    variant, decoder and input size) and return it: the keys are the
    port's own; BN's ``num_batches_tracked`` is dropped. Raises on any
    missing or unused tensor, or a shape mismatch."""
    return _load_checked(state_dict, model, "HF ViTPose")


def _split_indices(name):
    """A flax module name -> its torch key components: '__' spells '.',
    and trailing '_<index>' segments expand to '.<index>' recursively
    (``encoder_input_proj_0_1`` -> encoder_input_proj, 0, 1)."""
    import re

    comps = []
    for part in name.split("__"):
        stack = [part]
        while True:
            m = re.match(r"^(.*)_(\d+)$", stack[0])
            if not m:
                break
            stack = [m.group(1), m.group(2)] + stack[1:]
        comps.extend(stack)
    return comps


def _indexed_key(path) -> str:
    """Flax path (collection, *modules, leaf) -> torch key by
    :func:`_split_indices` (the JAX package's ``_rtdetr_hf_torch_key`` and
    ``_generic_torch_key`` rules)."""
    _, *mods, leaf = path
    comps = []
    for m in mods:
        comps.extend(_split_indices(m))
    return ".".join(comps + [_LEAF_MAP[leaf]])


# ----------------------------------------------------------------- RTMDet

def _rtmdet_keys(path):
    """Flax path of the JAX package's RTMDet -> the mmdet keys it fills:
    module names split as mmdet's segments (``stage1_2`` -> ``stage1.2``);
    the head's shared conv ``{cls,reg}_convs_share_j`` fills every level's
    ``{cls,reg}_convs.{lvl}.j.conv``, its BN ``{cls,reg}_bn_{lvl}_j`` the
    level's ``.bn``."""
    import re

    _, *mods, leaf = path
    comps, levels = [], [None]
    for m in mods:
        sh = re.match(r"^(cls|reg)_convs_share_(\d+)$", m)
        bn = re.match(r"^(cls|reg)_bn_(\d+)_(\d+)$", m)
        if sh:
            comps.extend([f"{sh.group(1)}_convs", "{lvl}", sh.group(2),
                          "conv"])
            levels = [0, 1, 2]
        elif bn:
            comps.extend([f"{bn.group(1)}_convs", bn.group(2), bn.group(3),
                          "bn"])
        else:
            comps.extend(_split_indices(m))
    key = ".".join(comps + [_LEAF_MAP[leaf]])
    return [key if lvl is None else key.replace("{lvl}", str(lvl))
            for lvl in levels]


def rtmdet_from_flax(variables) -> dict:
    """Flax RTMDet variables (the JAX package's ``models.rtmdet.RTMDet``)
    -> the mmdet-named state dict ``models.rtmdet.RTMDet`` loads with
    ``strict=True``; the head's shared conv kernels copied to each
    level."""
    out = {}
    for path, leaf in _flatten(variables):
        t = np.asarray(leaf, dtype=np.float32)
        if t.ndim == 4:
            t = t.transpose(3, 2, 0, 1)
        for key in _rtmdet_keys(path):
            out[key] = torch.tensor(np.ascontiguousarray(t))
    return out


def convert_rtmdet_torch(state_dict, model):
    """Load an mmdetection RTMDet state dict (tensors or numpy arrays; a
    ``state_dict``-style export whose keys start with ``backbone.``,
    ``neck.`` and ``bbox_head.``) into ``model`` (a ``models.rtmdet.RTMDet``
    of the same variant) and return it. The SepBN head shares its conv
    kernels across levels (mmdet's ``share_conv``): level 0's are loaded
    into every level and the other levels' copies, where present, are not
    read, as the JAX package's converter does. Raises on any other missing
    or unused tensor, or a shape mismatch."""
    import re

    tied = re.compile(r"^bbox_head\.(cls|reg)_convs\.([12])\.(\d+)\.conv\.")
    sd = {k: v for k, v in state_dict.items() if not tied.match(k)}
    for k in model.state_dict():
        src = tied.sub(r"bbox_head.\1_convs.0.\3.conv.", k)
        if src != k and src in sd:
            sd[k] = sd[src]
    return _load_checked(sd, model, "mmdet RTMDet")


# ---------------------------------------------------------------- RT-DETR

_RTDETR_TOP = {"CSPDarknet_0": "backbone", "Dense_0": "proj5",
               "Dense_1": "proj3", "Dense_2": "proj4", "Dense_3": "cls_head",
               "Dense_4": "box_head", "EncoderLayer_0": "encoder"}
_RTDETR_ENC = {"MultiHeadDotProductAttention_0": "attn",
               "LayerNorm_0": "norm1", "Dense_0": "ffn.fc1",
               "Dense_1": "ffn.fc2", "LayerNorm_1": "norm2"}
_RTDETR_DEC = {"MultiHeadDotProductAttention_0": "self_attn",
               "LayerNorm_0": "norm1",
               "MultiHeadDotProductAttention_1": "cross_attn",
               "LayerNorm_1": "norm2", "Dense_0": "ffn.fc1",
               "Dense_1": "ffn.fc2", "LayerNorm_2": "norm3"}


def rtdetr_from_flax(variables) -> dict:
    """Flax variables of the JAX package's lightweight ``models.rtdetr.
    RTDETR`` (flax auto-names, in the module's call order: the /32, /8 and
    /16 token projections, then the heads) -> the state dict
    ``models.rtdetr.RTDETR`` loads with ``strict=True``. The
    ``MultiHeadDotProductAttention`` kernels (dim, heads, head_dim) and
    (heads, head_dim, dim) become Linear weights (heads * head_dim, dim) and
    (dim, heads * head_dim)."""
    out = {}
    for path, leaf in _flatten(variables):
        t = np.asarray(leaf, dtype=np.float32)
        coll, top, *rest = path
        if top == "CSPDarknet_0":
            key = "backbone." + module_torch_key((coll, *rest))
            if t.ndim == 4:
                t = t.transpose(3, 2, 0, 1)
        elif top in ("pos5", "queries"):
            key = top
        else:
            if top.startswith("DecoderLayer_"):
                prefix = ["decoder", top.rsplit("_", 1)[1],
                          _RTDETR_DEC[rest[0]]]
                rest = rest[1:]
            elif top == "EncoderLayer_0":
                prefix = ["encoder", _RTDETR_ENC[rest[0]]]
                rest = rest[1:]
            else:
                prefix = [_RTDETR_TOP[top]]
            leaf_name = rest[-1]
            if prefix[-1].endswith("attn"):          # query/key/value/out
                prefix.append(rest[0])
                if leaf_name == "kernel":
                    t = (t.reshape(t.shape[0], -1) if rest[0] != "out"
                         else t.reshape(-1, t.shape[-1])).T
                else:
                    t = t.reshape(-1)
            elif leaf_name == "kernel":
                t = t.T
            key = ".".join(prefix + [_LEAF_MAP[leaf_name]])
        out[key] = torch.tensor(np.ascontiguousarray(t))
    return out


def rtdetr_hf_from_flax(variables) -> dict:
    """Flax variables of the JAX package's ``models.rtdetr_hf.RTDetrHF``
    (module names spelling the HF keys) -> the HF-named state dict
    ``models.rtdetr_hf.RTDetrHF`` loads with ``strict=True``."""
    return _pose_state_dict(variables, _indexed_key)


def convert_rtdetr_hf_torch(state_dict, model):
    """Load an HF ``RTDetrForObjectDetection`` state dict (tensors or numpy
    arrays; the PekingU rtdetr_* checkpoints) into ``model`` (a
    ``models.rtdetr_hf.RTDetrHF`` of the same variant) and return it. The
    prediction heads are tied into the decoder, so the
    ``model.decoder.{bbox,class}_embed.*`` alias fills the top-level names
    where those are absent; the denoising class table (training only), the
    anchor buffers and RT-DETRv2's ``n_points_scale`` buffers (whose
    released defaults reduce v2's sampling to this one's) are not read.
    Raises on any other missing or unused tensor, or a shape mismatch."""
    sd = dict(state_dict)
    for k in list(sd):
        for head in ("bbox_embed", "class_embed"):
            pref = f"model.decoder.{head}."
            if k.startswith(pref):
                sd.setdefault(k[len("model.decoder."):], sd[k])
    sd = {k: v for k, v in sd.items() if not k.endswith("n_points_scale")}
    return _load_checked(sd, model, "HF RT-DETR", unused_ok=(
        "model.decoder.bbox_embed.", "model.decoder.class_embed.",
        "model.denoising_class_embed.", "model.anchors",
        "model.valid_mask"))


# -------------------------------------------------------------- DeepLabV3

def deeplabv3_from_flax(variables) -> dict:
    """Flax variables of the JAX package's ``models.deeplabv3.DeepLabV3``
    (module names spelling torchvision's keys) -> the torchvision-named
    state dict ``models.deeplabv3.DeepLabV3`` loads with ``strict=True``."""
    return _pose_state_dict(variables, _indexed_key)


def convert_deeplabv3_torch(state_dict, model):
    """Load a torchvision DeepLabV3-ResNet101 state dict (tensors or numpy
    arrays; the SoccerNet pitch-line checkpoint keeps it under ``model``,
    which is unwrapped) into ``model`` (a ``models.deeplabv3.DeepLabV3``)
    and return it: a ``module.`` prefix is dropped; without ``model.aux``
    the aux classifier's tensors are not read. Raises on any other missing
    or unused tensor, or a shape mismatch."""
    if isinstance(state_dict.get("model"), Mapping):
        state_dict = state_dict["model"]
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in state_dict.items()}
    return _load_checked(sd, model, "torchvision DeepLabV3",
                         unused_ok=() if model.aux else ("aux_classifier.",))
