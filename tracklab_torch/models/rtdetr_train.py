"""RT-DETR fine-tuning loss in PyTorch (counterpart of
tracklab_tpu.models.rtdetr_train): set matching on cost = 2 focal class + 5
L1 + 2 (-GIoU) (HF's matcher weights), then the varifocal class loss (soft
targets scaled by the matched IoU) and the L1 and GIoU box losses with HF's
weights {vfl: 1, bbox: 5, giou: 2}, on the last decoder layer only.

The JAX package vmaps one image at a time and solves each matching with
``matching_forced(..., batched=True)``; here the whole (B, Q, G) cost stack
goes to one ``ops/assignment.py:matching_forced(..., batched=True)`` call,
so a training step makes one launch of kernel K2 on the card (the problem
transposed to (B, G, Q) when Q > G, as ``_forced_rect`` does), with no host
sync. The matching computes no gradient (its result is an index map in both
packages).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tracklab_torch.ops.assignment import matching_forced

__all__ = ["rtdetr_detection_loss", "matching_costs"]

ALPHA, GAMMA = 0.75, 2.0  # HF RTDetrLoss's varifocal defaults


def _cxcywh_to_ltrb(b):
    c, s = b[..., :2], b[..., 2:4]
    return torch.cat([c - s / 2, c + s / 2], -1)


def _giou_pairs(a, b):
    """Elementwise (GIoU, IoU) of (..., 4) ltrb box pairs."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    inter = torch.clamp(rb - lt, min=0).prod(-1)
    area_a = torch.clamp(a[..., 2:] - a[..., :2], min=0).prod(-1)
    area_b = torch.clamp(b[..., 2:] - b[..., :2], min=0).prod(-1)
    union = area_a + area_b - inter
    iou = inter / torch.clamp(union, min=1e-9)
    clt = torch.minimum(a[..., :2], b[..., :2])
    crb = torch.maximum(a[..., 2:], b[..., 2:])
    hull = torch.clamp(crb - clt, min=0).prod(-1)
    return iou - (hull - union) / torch.clamp(hull, min=1e-9), iou


def _targets(gt_boxes, input_hw):
    """(B, G, 5) [cx, cy, w, h, cls] in pixels -> boxes normalised like the
    predictions and int64 classes."""
    h, w = input_hw
    scale = torch.tensor([w, h, w, h], dtype=torch.float32,
                         device=gt_boxes.device)
    return gt_boxes[..., :4].float() / scale, gt_boxes[..., 4].long()


@torch.no_grad()
def matching_costs(logits, boxes, gt_boxes, input_hw):
    """The (B, Q, G) matching costs of HF's ``RTDetrHungarianMatcher``."""
    g_box, g_cls = _targets(gt_boxes, input_hw)
    B, Q, _ = logits.shape
    prob = torch.sigmoid(logits.float())
    p = torch.clamp(torch.gather(prob, 2, g_cls[:, None, :].expand(
        B, Q, g_cls.shape[1])), 1e-6, 1 - 1e-6)                # (B, Q, G)
    neg = (1 - 0.25) * p ** 2.0 * (-torch.log1p(-p))
    pos = 0.25 * (1 - p) ** 2.0 * (-torch.log(p))
    bx = boxes.float()
    cost_bbox = (bx[:, :, None, :] - g_box[:, None, :, :]).abs().sum(-1)
    giou, _ = _giou_pairs(_cxcywh_to_ltrb(bx)[:, :, None, :],
                          _cxcywh_to_ltrb(g_box)[:, None, :, :])
    return 2.0 * (pos - neg) + 5.0 * cost_bbox + 2.0 * (-giou)


def rtdetr_detection_loss(outs, gt_boxes, gt_valid, input_hw,
                          num_classes: int):
    """outs: (logits (B, Q, C), boxes (B, Q, 4) normalised cxcywh);
    gt_boxes (B, G, 5) [cx, cy, w, h, cls] in input pixels; gt_valid (B, G)
    bool. ``train_detector``'s ``detection_loss_fn`` contract. Returns the
    batch's mean loss."""
    logits, boxes = outs[0].float(), outs[1].float()
    B, Q, _ = logits.shape
    g_box, g_cls = _targets(gt_boxes, input_hw)
    cost = matching_costs(logits, boxes, gt_boxes, input_hw)
    rows = torch.ones((B, Q), dtype=torch.bool, device=logits.device)
    q2g = matching_forced(cost, rows, gt_valid, batched=True)    # (B, Q)
    matched = q2g >= 0
    gi = torch.clamp(q2g, min=0).long()
    m_gbox = torch.gather(g_box, 1, gi[..., None].expand(B, Q, 4))
    m_gcls = torch.gather(g_cls, 1, gi)
    giou_m, iou_m = _giou_pairs(_cxcywh_to_ltrb(boxes),
                                _cxcywh_to_ltrb(m_gbox))
    n_boxes = torch.clamp(gt_valid.sum(1), min=1).float()        # (B,)
    mf = matched.float()

    prob = torch.sigmoid(logits)
    onehot = F.one_hot(m_gcls, num_classes).float() * mf[..., None]
    target = onehot * iou_m.detach()[..., None]
    weight = ALPHA * prob ** GAMMA * (1 - onehot) + target
    bce = (torch.clamp(logits, min=0) - logits * target
           + torch.log1p(torch.exp(-logits.abs())))
    loss_vfl = (bce * weight).mean(2).sum(1) * Q / n_boxes
    loss_bbox = ((boxes - m_gbox).abs().sum(-1) * mf).sum(1) / n_boxes
    loss_giou = ((1 - giou_m) * mf).sum(1) / n_boxes
    return (1.0 * loss_vfl + 5.0 * loss_bbox + 2.0 * loss_giou).mean()
