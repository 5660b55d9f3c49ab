"""Pitch-line semantic segmentation in PyTorch, the calibration front-end
(counterpart of tracklab_tpu.models.segmentation).

``PitchSegNet``: the port's YOLOX CSPDarknet (``models/yolox.py``, so on the
card kernel K3 runs its dense CSPLayers of 80 x 80 pixels or less) with a
DeepLabV3+-style head: ASPP over the stride-16 feature, the stride-8
low-level skip, bilinear upsampling. The stride-32 stage is not computed:
its output feeds nothing (the JAX package's compiler drops it too), though
its weights stay in the state dict. :func:`extract_segment_points` turns a
class map into a fixed number of pixel points per line on the device.
:func:`seg_loss` is the segmenter's training loss, a class-weighted softmax
cross-entropy.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tracklab_torch.device import resolve_device
from tracklab_torch.models.yolox import (YOLOX, YOLOX_VARIANTS, BatchNorm,
                                         ConvBnAct, CSPDarknet, _PredConv,
                                         _round_width)

__all__ = ["PitchSegNet", "ASPP", "extract_segment_points", "seg_loss"]

_FLAX_BN_EPS = 1e-5   # flax nn.BatchNorm's default, used by ASPP's branches


class _Atrous(nn.Module):
    """3x3 dilated conv (no bias) + BN (eps 1e-5) + SiLU."""

    def __init__(self, cin, cout, rate, dtype=torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, 1, rate, dilation=rate,
                              bias=False)
        self.bn = BatchNorm(cout, eps=_FLAX_BN_EPS)
        self.dtype = dtype

    def forward(self, x):
        y = F.conv2d(x.to(self.dtype), self.conv.weight.to(self.dtype), None,
                     1, self.conv.padding, self.conv.dilation)
        return F.silu(self.bn(y)).to(self.dtype)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a 1x1 branch, one dilated 3x3 per
    rate, an image-level mean branch, concatenated into a 1x1 projection."""

    def __init__(self, cin, features, rates=(3, 6, 9), dtype=torch.float32):
        super().__init__()
        self.b0 = ConvBnAct(cin, features, 1, dtype=dtype)
        self.atrous = nn.ModuleList(_Atrous(cin, features, r, dtype=dtype)
                                    for r in rates)
        self.pool = ConvBnAct(cin, features, 1, dtype=dtype)
        self.project = ConvBnAct(features * (len(rates) + 2), features, 1,
                                 dtype=dtype)

    def forward(self, x):
        branches = [self.b0(x)] + [a(x) for a in self.atrous]
        g = self.pool(x.mean(dim=(2, 3), keepdim=True))
        branches.append(g.expand(-1, -1, x.shape[2], x.shape[3]))
        return self.project(torch.cat(branches, dim=1))


class PitchSegNet(nn.Module):
    """images (B, H, W, 3) in [0, 255] -> per-pixel class logits
    (B, H, W, C) in f32. Class 0 is background; classes 1..C-1 are the
    segments of ``calibration.pitch.pitch_segments`` in its order."""

    def __init__(self, num_classes: int, variant: str = "s",
                 head_features: int = 128, dtype=torch.float32, device=None):
        super().__init__()
        v = YOLOX_VARIANTS[variant]
        self.backbone = CSPDarknet(v["depth_mult"], v["width_mult"],
                                   v["depthwise"], dtype=dtype)
        c3 = _round_width(256, v["width_mult"])
        c4 = _round_width(512, v["width_mult"])
        self.aspp = ASPP(c4, head_features, dtype=dtype)
        self.low = ConvBnAct(c3, head_features // 2, 1, dtype=dtype)
        self.fuse = ConvBnAct(head_features + head_features // 2,
                              head_features, 3, dtype=dtype)
        self.cls = _PredConv(head_features, num_classes, dtype)
        self.num_classes, self.dtype = num_classes, dtype
        self.eval()
        self.to(resolve_device(device))

    def forward(self, images):
        ih, iw = images.shape[1:3]
        x = images.permute(0, 3, 1, 2).to(self.dtype) / 255.0
        x = x.contiguous(memory_format=torch.channels_last)
        bb = self.backbone
        c3 = bb.dark3(bb.dark2(bb.stem(x)))
        c4 = bb.dark4(c3)
        y = F.interpolate(self.aspp(c4), size=c3.shape[2:], mode="bilinear",
                          align_corners=False)
        y = self.fuse(torch.cat([y, self.low(c3)], dim=1))
        logits = F.interpolate(self.cls(y).float(), size=(ih, iw),
                               mode="bilinear", align_corners=False)
        return logits.permute(0, 2, 3, 1)

    @torch.no_grad()
    def predict(self, images):
        """Per-pixel argmax class map (B, H, W) int32 (the lowest class
        among equal logits)."""
        return torch.argmax(self(images), dim=-1).to(torch.int32)

    randomize_ = YOLOX.randomize_


_KNUTH = 2654435761


def seg_loss(logits, labels, background_weight: float = 0.05):
    """Class-weighted softmax cross-entropy over (B, H, W, C) logits and
    (B, H, W) integer labels: pitch lines are ~1 % of the pixels, so the
    background (class 0) is weighted down; the weighted sum over the
    pixels divided by the weights' sum (at least 1)."""
    logp = torch.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    w = torch.where(labels == 0, logits.new_tensor(background_weight),
                    logits.new_tensor(1.0))
    ce = -(onehot * logp).sum(-1) * w
    return ce.sum() / torch.clamp(w.sum(), min=1.0)


def extract_segment_points(class_map, num_classes: int, n_points: int = 32):
    """Class map (..., H, W) int -> per-class pixel samples of fixed shape:
    xy (..., num_classes - 1, n_points, 2) f32 pixel coordinates for
    classes 1..num_classes-1 and valid (..., num_classes - 1, n_points).

    Points spread over each line by a per-pixel hash: the JAX package's
    uint32 Knuth hash ``(idx * 2654435761) >> 12`` with wrap-around, here in
    int64 masked to 32 bits; a pixel of the class scores 1 + hash / 2^20,
    any other hash / 2^20 - 1, and the top ``n_points`` scores are kept,
    equal scores by the lower index (``lax.top_k``'s order). The scores are
    exact multiples of 2^-20, so they are ranked as integers with the
    index folded in below them: one ``topk`` over keys that never tie. A
    kept point is valid where its score exceeds 1 (a class pixel whose hash
    is 0 scores exactly 1 and is not, as in the JAX package)."""
    h, w = class_map.shape[-2:]
    hw = h * w
    flat = class_map.reshape(class_map.shape[:-2] + (1, hw))
    idx = torch.arange(hw, dtype=torch.int64, device=class_map.device)
    tie = ((idx * _KNUTH) & 0xFFFFFFFF) >> 12                 # 20 bits
    classes = torch.arange(1, num_classes, dtype=flat.dtype,
                           device=class_map.device)[:, None]
    hit = flat == classes                                     # (..., C-1, HW)
    score = torch.where(hit, tie + (1 << 20), tie - (1 << 20))
    key = score * hw + (hw - 1 - idx)
    top, where = torch.topk(key, n_points, dim=-1)
    xy = torch.stack([(where % w).to(torch.float32),
                      (where // w).to(torch.float32)], dim=-1)
    valid = torch.div(top, hw, rounding_mode="floor") > (1 << 20)
    return xy, valid
