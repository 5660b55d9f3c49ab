"""Detector training step in PyTorch (counterpart of
tracklab_tpu.models.train).

A supervised detection objective over the YOLOX head's raw maps: anchors
whose cell centre lies inside a ground-truth box and within a centre radius
are candidates, refined by SimOTA's dynamic-k assignment; the loss is BCE
on objectness and class and IoU on the boxes of the positives. The model
and its BN statistics are the ``nn.Module``'s own, and any ``torch.optim``
optimizer takes the place of the optax transform.

The assignment follows the JAX package's ties: ``argsort`` is asked to be
stable where ``jnp.argsort`` is, and ``argmin``/``argmax`` return the first
extreme index as ``jnp.argmin``/``jnp.argmax`` do. It computes no gradient
(its result is boolean in both packages).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from tracklab_torch.models.yolox import decode_outputs

__all__ = ["TrainState", "create_train_state", "detection_loss",
           "make_train_step"]


class TrainState(NamedTuple):
    """The model (parameters and BN statistics), its optimizer (the
    optimizer's state) and the count of steps taken."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int


def create_train_state(model, tx) -> TrainState:
    """``tx``: a callable from parameters to a ``torch.optim`` optimizer,
    e.g. ``functools.partial(torch.optim.AdamW, lr=1e-4,
    weight_decay=1e-4)`` for ``optax.adamw(1e-4)``."""
    return TrainState(model, tx(model.parameters()), 0)


def _pairwise_iou_xywh(a, b):
    """(..., N, 4) xywh x (..., M, 4) xywh -> (..., N, M) IoU."""
    ax1, ay1 = a[..., 0] - a[..., 2] / 2, a[..., 1] - a[..., 3] / 2
    ax2, ay2 = a[..., 0] + a[..., 2] / 2, a[..., 1] + a[..., 3] / 2
    bx1, by1 = b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2
    bx2, by2 = b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2
    xx1 = torch.maximum(ax1[..., :, None], bx1[..., None, :])
    yy1 = torch.maximum(ay1[..., :, None], by1[..., None, :])
    xx2 = torch.minimum(ax2[..., :, None], bx2[..., None, :])
    yy2 = torch.minimum(ay2[..., :, None], by2[..., None, :])
    inter = torch.clamp(xx2 - xx1, min=0) * torch.clamp(yy2 - yy1, min=0)
    ua = ((a[..., 2] * a[..., 3])[..., :, None]
          + (b[..., 2] * b[..., 3])[..., None, :] - inter)
    return inter / torch.clamp(ua, min=1e-9)


def _anchor_centers(input_hw, strides=(8, 16, 32), device=None):
    """(A, 2) cell centres in input pixels and (A,) strides, level by
    level in row-major order (``decode_outputs``' order)."""
    centers, stride_arr = [], []
    H, W = input_hw
    for s in strides:
        h, w = H // s, W // s
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=device),
            torch.arange(w, dtype=torch.float32, device=device),
            indexing="ij")
        centers.append(torch.stack([(gx + 0.5) * s, (gy + 0.5) * s],
                                   -1).reshape(-1, 2))
        stride_arr.append(torch.full((h * w,), float(s), device=device))
    return torch.cat(centers), torch.cat(stride_arr)


@torch.no_grad()
def _simota_assign(pos_mat, iou, cls_logit, obj_logit, tgt_cls_ids, valid,
                   num_classes, topk_ious: int = 10):
    """SimOTA dynamic-k assignment over a batch.

    pos_mat: (B, A, G) centre-prior candidates; iou: (B, A, G) predicted
    box x ground-truth IoU. Returns the refined (B, A, G) positives: per
    ground truth its dynamic-k lowest-cost candidates, an anchor claimed by
    several kept by its lowest-cost one."""
    A, G = pos_mat.shape[1:]
    probs = (torch.sigmoid(cls_logit)
             * torch.sigmoid(obj_logit)[..., None])          # (B, A, C)
    onehot = F.one_hot(tgt_cls_ids, num_classes).to(probs.dtype)
    p = torch.clamp(probs[:, :, None, :], 1e-6, 1 - 1e-6)    # (B, A, 1, C)
    oh = onehot[:, None]                                     # (B, 1, G, C)
    cls_cost = -torch.sum(oh * torch.log(p) + (1 - oh) * torch.log(1 - p),
                          dim=-1)                            # (B, A, G)
    iou_cost = -torch.log(torch.clamp(iou, 1e-8, 1.0))
    cost = cls_cost + 3.0 * iou_cost + 1e5 * (~pos_mat)
    # dynamic k per ground truth: the sum of its top-10 candidate IoUs
    k = min(topk_ious, A)
    iou_cand = torch.where(pos_mat, iou, torch.zeros_like(iou))
    topv = torch.topk(iou_cand.transpose(1, 2), k, dim=-1).values
    dyn_k = torch.clamp(topv.sum(-1).to(torch.int32), 1, k)  # (B, G)
    # each ground truth takes its dyn_k lowest-cost anchors
    order = torch.argsort(cost, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    chosen = (rank < dyn_k[:, None, :]) & pos_mat & valid[:, None, :]
    multi = chosen.sum(2) > 1
    best_g = torch.argmin(torch.where(chosen, cost, torch.full_like(
        cost, float("inf"))), dim=2)
    keep = F.one_hot(best_g, G).bool() & chosen
    return torch.where(multi[..., None], keep, chosen)


def _bce(logits, targets):
    """``optax.sigmoid_binary_cross_entropy``, elementwise."""
    return F.binary_cross_entropy_with_logits(logits, targets,
                                              reduction="none")


def detection_loss(outputs, gt_boxes, gt_valid, input_hw, num_classes: int,
                   center_radius: float = 2.5, simota: bool = True):
    """outputs: the per-level raw NHWC maps; gt_boxes: (B, G, 5) [xywh,
    cls] in input pixels; gt_valid: (B, G) bool. Returns the batch's mean
    of obj + 5 box + cls. With ``simota`` the centre-prior candidates are
    refined by SimOTA (YOLOX's assigner); otherwise the centre prior
    assigns directly."""
    dec = decode_outputs(outputs, apply_sigmoid=False)       # (B, A, 5+C)
    centers, strides = _anchor_centers(input_hw, device=dec.device)
    gt_boxes = gt_boxes.to(dec.dtype)
    pred_xywh, obj_logit, cls_logit = dec[..., :4], dec[..., 4], dec[..., 5:]
    gx, gy = gt_boxes[..., 0][:, None], gt_boxes[..., 1][:, None]
    gw, gh = gt_boxes[..., 2][:, None], gt_boxes[..., 3][:, None]
    cx, cy = centers[:, 0][None, :, None], centers[:, 1][None, :, None]
    in_box = ((cx > gx - gw / 2) & (cx < gx + gw / 2)
              & (cy > gy - gh / 2) & (cy < gy + gh / 2))
    r = center_radius * strides[None, :, None]
    in_center = (torch.abs(cx - gx) < r) & (torch.abs(cy - gy) < r)
    pos_mat = in_box & in_center & gt_valid[:, None, :]       # (B, A, G)
    iou = _pairwise_iou_xywh(pred_xywh, gt_boxes[..., :4])
    cls_ids = gt_boxes[..., 4].to(torch.int64)
    if simota:
        pos_mat = _simota_assign(pos_mat, iou.detach(), cls_logit.detach(),
                                 obj_logit.detach(), cls_ids, gt_valid,
                                 num_classes)
    # each anchor -> its best-IoU ground truth among its candidates
    best_gt = torch.argmax(torch.where(pos_mat, iou.detach(),
                                       torch.full_like(iou, -1.0)), dim=2)
    is_pos = pos_mat.any(2)
    tgt_box = torch.gather(gt_boxes[..., :4], 1,
                           best_gt[..., None].expand(-1, -1, 4))
    tgt_cls = torch.gather(cls_ids, 1, best_gt)
    obj_tgt = is_pos.to(dec.dtype)
    n_pos = torch.clamp(obj_tgt.sum(1), min=1.0)
    obj_loss = _bce(obj_logit, obj_tgt).mean(1)
    iou_pos = _pairwise_iou_xywh(pred_xywh[..., None, :],
                                 tgt_box[..., None, :])[..., 0, 0]
    zero = torch.zeros((), dtype=dec.dtype, device=dec.device)
    box_loss = torch.where(is_pos, 1.0 - iou_pos, zero).sum(1) / n_pos
    cls_bce = _bce(cls_logit, F.one_hot(tgt_cls, num_classes)
                   .to(dec.dtype)).sum(-1)
    cls_loss = torch.where(is_pos, cls_bce, zero).sum(1) / n_pos
    return (obj_loss + 5.0 * box_loss + cls_loss).mean()


def make_train_step(input_hw):
    """Returns ``train_step(state, batch) -> (state, loss)``: one forward
    in ``train()`` mode (BN on the batch's statistics, which also updates
    the running ones), the loss, its backward and one optimizer step.
    ``batch``: ``images`` (B, H, W, 3) on the model's device (YOLOX's raw
    0-255 pixels, any dtype), ``gt_boxes`` (B, G, 5) and ``gt_valid``
    (B, G). The gradients stay in each parameter's ``.grad`` until the
    next step."""

    def train_step(state: TrainState, batch):
        model, opt = state.model, state.optimizer
        model.train()
        loss = detection_loss(model(batch["images"].float()),
                              batch["gt_boxes"], batch["gt_valid"], input_hw,
                              model.num_classes)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return state._replace(step=state.step + 1), loss.detach()

    return train_step
