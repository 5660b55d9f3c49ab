"""Checkpoint manifests: the torch key set each family's converter reads
(counterpart of tracklab_tpu.models.manifest).

* :func:`expected_torch_keys` lists, for a family's canonical build, the
  state-dict keys a checkpoint of that family must hold: the port model's
  own ``state_dict()`` keys (built on the ``meta`` device, so no weight is
  made), less what no upstream checkpoint holds (BN's
  ``num_batches_tracked``, OSNet's part head, the tied copies of RTMDet's
  head convs). The JAX package's manifests (``tests/manifests/``) are the
  same sets.
* :func:`family_for_checkpoint` names a checkpoint's family from its file
  name, :func:`discover_checkpoints` finds the recognisable files under a
  directory, and :func:`validate_checkpoint` loads one
  (``convert.load_checkpoint``) and runs a forward pass on the card (or on
  the device the caller names); an entry may name a torch file or an
  orbax directory.
"""
from __future__ import annotations

import re
from pathlib import Path

import torch

__all__ = ["FAMILIES", "expected_torch_keys", "family_for_checkpoint",
           "validate_checkpoint", "discover_checkpoints"]


def _yolox(variant):
    def build(device):
        from tracklab_torch.models.yolox import YOLOX
        return YOLOX(num_classes=80, variant=variant,
                     device=device), (1, 640, 640, 3)
    return build


def _yolov8(variant):
    def build(device):
        from tracklab_torch.models.yolov8 import YOLOv8
        return YOLOv8(num_classes=80, variant=variant,
                      device=device), (1, 640, 640, 3)
    return build


def _yolo11(variant):
    def build(device):
        from tracklab_torch.models.yolo11 import YOLO11
        return YOLO11(num_classes=80, variant=variant,
                      device=device), (1, 640, 640, 3)
    return build


def _yolo11_pose(device):
    from tracklab_torch.models.yolo11 import YOLO11Pose
    # made on the CPU whatever ``device``: it builds its base model there
    # before it swaps the head in (the nano weights are small)
    with torch.device("cpu"):
        return YOLO11Pose(num_classes=1, num_keypoints=17, variant="n",
                          device="cpu"), (1, 640, 640, 3)


def _vitpose(device):
    from tracklab_torch.models.vitpose import ViTPose
    return ViTPose(num_keypoints=17, variant="base",
                   device=device), (1, 256, 192, 3)


def _rtmdet(variant):
    def build(device):
        from tracklab_torch.models.rtmdet import RTMDet
        return RTMDet(num_classes=80, variant=variant,
                      device=device), (1, 640, 640, 3)
    return build


def _osnet(device):
    from tracklab_torch.models.osnet import OSNet
    return OSNet("x1_0", device=device), (1, 256, 128, 3)


def _kpr(device):
    from tracklab_torch.models.kpr import KPR
    return KPR(device=device), (1, 384, 128, 3)


def _deeplabv3_pitch(device):
    from tracklab_torch.models.deeplabv3 import DeepLabV3
    return DeepLabV3(device=device), (1, 256, 456, 3)


def _reid(name):
    def build(device):
        from tracklab_torch.wrappers.reid.osnet_api import (
            select_backbone_model,
        )
        crop = (160, 64) if name == "hacnn" else (256, 128)
        return (select_backbone_model(name, crop_size=crop, device=device),
                (1,) + crop + (3,))
    return build


# family -> (make(device) -> (model, NHWC input shape), file-name regex)
FAMILIES = {
    "yolox_s": (_yolox("s"), r"yolox_s"),
    "yolox_m": (_yolox("m"), r"yolox_m"),
    "yolox_nano": (_yolox("nano"), r"yolox_nano"),
    "yolox_tiny": (_yolox("tiny"), r"yolox_tiny"),
    "yolov8_n": (_yolov8("n"), r"yolov8n"),
    "yolov8_s": (_yolov8("s"), r"yolov8s"),
    "yolo11_n": (_yolo11("n"), r"yolo11n(?!-pose)"),
    "yolo11_s": (_yolo11("s"), r"yolo11s(?!-pose)"),
    "yolo11_pose_n": (_yolo11_pose, r"yolo11n-pose"),
    "vitpose_b": (_vitpose, r"vitpose"),
    "rtmdet_nano": (_rtmdet("nano"), r"rtmdet_?nano"),
    "rtmdet_tiny": (_rtmdet("tiny"), r"rtmdet_?tiny"),
    "osnet_x1_0": (_osnet, r"osnet_x1_0"),
    "kpr": (_kpr, r"kpr_"),
    "resnet50_reid": (_reid("resnet50"), r"resnet50(?!mid|_ibn|_fc)"),
    "mobilenetv2_reid": (_reid("mobilenetv2_x1_0"), r"mobilenetv2"),
    "densenet121_reid": (_reid("densenet121"), r"densenet121"),
    "mlfn_reid": (_reid("mlfn"), r"mlfn"),
    "hacnn_reid": (_reid("hacnn"), r"hacnn"),
    "pcb_p6_reid": (_reid("pcb_p6"), r"pcb_p6"),
    "osnet_ain_x1_0": (_reid("osnet_ain_x1_0"), r"osnet_ain_x1_0"),
    # the SoccerNet pitch-line segmenter (its checkpoint ships as e.g.
    # train_59.pt)
    "deeplabv3_pitch": (_deeplabv3_pitch,
                        r"deeplab|pitch.?seg|train_59"),
}

# keys of the port's models that no upstream checkpoint holds
_UNREAD = re.compile(
    r"num_batches_tracked$"
    r"|^part_fc\."                                   # OSNet's part head
    r"|^bbox_head\.(cls|reg)_convs\.[12]\.\d+\.conv\.")  # RTMDet's ties


def expected_torch_keys(family: str) -> list:
    """Sorted torch keys a checkpoint of ``family`` holds for the family's
    canonical build (built on the ``meta`` device: no weights)."""
    make, _ = FAMILIES[family]
    with torch.device("meta"):
        model, _ = make("meta")
    return sorted(k for k in model.state_dict() if not _UNREAD.search(k))


def family_for_checkpoint(path) -> str | None:
    """The family of a checkpoint file by its name; None when none
    matches."""
    name = Path(path).name.lower()
    for family, (_, pattern) in FAMILIES.items():
        if re.search(pattern, name):
            return family
    return None


def discover_checkpoints(root="cache"):
    """(path, family) for every recognisable torch checkpoint under
    ``root``."""
    root = Path(root)
    if not root.exists():
        return []
    out = []
    for p in sorted(root.rglob("*")):
        if p.suffix.lower() in (".pth", ".pt", ".bin") or \
                p.name.endswith(".pth.tar"):
            fam = family_for_checkpoint(p)
            if fam is not None:
                out.append((p, fam))
    return out


@torch.no_grad()
def validate_checkpoint(path, family: str, device=None):
    """Load a checkpoint (a torch, TorchScript or .onnx file, or the JAX
    package's orbax directory, as ``convert.load_checkpoint`` reads them)
    into the family's canonical build on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``) and run one forward pass on zeros; returns its
    output. Raises on any key or shape mismatch (the converters and the
    flax maps load strict)."""
    from tracklab_torch.device import resolve_device
    from tracklab_torch.models.convert import load_checkpoint

    dev = resolve_device(device)
    make, _ = FAMILIES[family]
    model, shape = make(dev)
    model = load_checkpoint(path, model).to(dev)
    return model(torch.zeros(shape, device=dev))
