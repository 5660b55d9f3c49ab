"""Pairwise box geometry in PyTorch (counterpart of tracklab_tpu.ops.boxes).

Conventions:
  - ``ltrb``: [x1, y1, x2, y2]
  - ``xywh``: [center-x, center-y, w, h]
  - ``ltwh``: [x1, y1, w, h]
  - ``xyah``: [center-x, center-y, w/h, h] (DeepSORT/ByteTrack KF)
  - ``xysr``: [center-x, center-y, scale=area, ratio=w/h] (OC-SORT KF)

Pairwise functions return an (..., N, M) matrix for boxes1 (..., N, 4) x
boxes2 (..., M, 4), with any leading batch dims. Padded slots are handled
by the callers' masks.
"""
from __future__ import annotations

import math

import torch

__all__ = ["xywh_to_ltrb", "ltrb_to_ltwh", "ltwh_to_xyah", "ltrb_to_xysr",
           "xysr_to_ltrb", "iou_matrix", "pairwise_iou", "giou_matrix",
           "diou_matrix", "ciou_matrix"]


def xywh_to_ltrb(b):
    cx, cy, w, h = b.unbind(-1)
    hw, hh = w * 0.5, h * 0.5
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)


def ltrb_to_ltwh(b):
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)


def ltwh_to_xyah(b):
    """DeepSORT measurement space: center-x, center-y, w/h, h
    (byte_tracker.py:119-128 tlwh_to_xyah)."""
    l, t, w, h = b.unbind(-1)
    return torch.stack([l + w * 0.5, t + h * 0.5, w / h, h], dim=-1)


def ltrb_to_xysr(b, eps: float = 1e-6):
    """Center-x, center-y, area, w/h, with the reference's h+eps guard."""
    x1, y1, x2, y2 = b.unbind(-1)
    w = x2 - x1
    h = y2 - y1
    return torch.stack([x1 + w * 0.5, y1 + h * 0.5, w * h, w / (h + eps)],
                       dim=-1)


def xysr_to_ltrb(z):
    """Inverse of :func:`ltrb_to_xysr`; a negative area gives NaN."""
    x, y, s, r = z.unbind(-1)
    w = torch.sqrt(s * r)
    h = s / w
    hw, hh = w * 0.5, h * 0.5
    return torch.stack([x - hw, y - hh, x + hw, y + hh], dim=-1)


def _pairwise_parts(b1, b2):
    b1 = b1[..., :, None, :]
    b2 = b2[..., None, :, :]
    xx1 = torch.maximum(b1[..., 0], b2[..., 0])
    yy1 = torch.maximum(b1[..., 1], b2[..., 1])
    xx2 = torch.minimum(b1[..., 2], b2[..., 2])
    yy2 = torch.minimum(b1[..., 3], b2[..., 3])
    inter = (xx2 - xx1).clamp(min=0.0) * (yy2 - yy1).clamp(min=0.0)
    area1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    area2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    union = area1 + area2 - inter
    return b1, b2, inter, union


def iou_matrix(b1, b2):
    """Pairwise IoU; union == 0 gives inf/NaN like the reference."""
    _, _, inter, union = _pairwise_parts(b1, b2)
    return inter / union


def pairwise_iou(b1, b2):
    """IoU with a zero-union guard (NMS and evaluation)."""
    _, _, inter, union = _pairwise_parts(b1, b2)
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union,
                                                torch.ones_like(union)),
                       torch.zeros_like(union))


def _enclosing(b1, b2):
    return (torch.minimum(b1[..., 0], b2[..., 0]),
            torch.minimum(b1[..., 1], b2[..., 1]),
            torch.maximum(b1[..., 2], b2[..., 2]),
            torch.maximum(b1[..., 3], b2[..., 3]))


def _center_dists(b1, b2):
    cx1 = (b1[..., 0] + b1[..., 2]) * 0.5
    cy1 = (b1[..., 1] + b1[..., 3]) * 0.5
    cx2 = (b2[..., 0] + b2[..., 2]) * 0.5
    cy2 = (b2[..., 1] + b2[..., 3]) * 0.5
    return (cx1 - cx2) ** 2 + (cy1 - cy2) ** 2


def giou_matrix(b1, b2):
    """Pairwise GIoU rescaled to (0, 1)."""
    e1, e2, inter, union = _pairwise_parts(b1, b2)
    iou = inter / union
    xxc1, yyc1, xxc2, yyc2 = _enclosing(e1, e2)
    area_c = (xxc2 - xxc1) * (yyc2 - yyc1)
    giou = iou - (area_c - inter) / area_c
    return (giou + 1.0) * 0.5


def diou_matrix(b1, b2):
    """Pairwise DIoU rescaled to (0, 1)."""
    e1, e2, inter, union = _pairwise_parts(b1, b2)
    iou = inter / union
    inner = _center_dists(e1, e2)
    xxc1, yyc1, xxc2, yyc2 = _enclosing(e1, e2)
    outer = (xxc2 - xxc1) ** 2 + (yyc2 - yyc1) ** 2
    return (iou - inner / outer + 1.0) * 0.5


def ciou_matrix(b1, b2):
    """Pairwise CIoU rescaled to (0, 1), with the reference's +1 px h
    shift before the arctan term."""
    e1, e2, inter, union = _pairwise_parts(b1, b2)
    iou = inter / union
    inner = _center_dists(e1, e2)
    xxc1, yyc1, xxc2, yyc2 = _enclosing(e1, e2)
    outer = (xxc2 - xxc1) ** 2 + (yyc2 - yyc1) ** 2
    w1 = e1[..., 2] - e1[..., 0]
    h1 = e1[..., 3] - e1[..., 1] + 1.0
    w2 = e2[..., 2] - e2[..., 0]
    h2 = e2[..., 3] - e2[..., 1] + 1.0
    arctan = torch.atan(w2 / h2) - torch.atan(w1 / h1)
    v = (4.0 / (math.pi ** 2)) * arctan ** 2
    alpha = v / ((1.0 - iou) + v)
    return (iou - inner / outer - alpha * v + 1.0) * 0.5
