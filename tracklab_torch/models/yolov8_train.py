"""YOLOv8/YOLO11 fine-tuning loss in PyTorch (counterpart of
tracklab_tpu.models.yolov8_train): task-aligned assignment (top 10, alpha
0.5, beta 6, an anchor in several boxes kept by its highest overlap), CIoU
box loss and distribution focal loss on the reg_max bins, BCE class loss
with the normalised alignment as soft target; gains box 7.5, cls 0.5, dfl
1.5 (ultralytics' v8DetectionLoss).

The JAX package vmaps one image at a time; here the batch axis leads every
tensor, with the same fixed shapes (A anchors x G ground-truth slots). The
assignment runs without gradient on detached predictions, as JAX's
``stop_gradient`` does. Its ties: ``argmax`` returns the first extreme index
as ``jnp.argmax`` does, and the top-k step reads only the k-th largest
value, which ``torch.topk`` gives exactly whatever its tie order.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["v8_detection_loss", "tal_assign"]


def _anchor_points(input_hw, strides=(8, 16, 32), device=None):
    """(A, 2) cell centres in input pixels and (A,) strides, level by level
    in row-major order (the head's order)."""
    pts, st = [], []
    H, W = input_hw
    for s in strides:
        h, w = H // s, W // s
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=device),
            torch.arange(w, dtype=torch.float32, device=device),
            indexing="ij")
        pts.append(torch.stack([(gx + 0.5) * s, (gy + 0.5) * s],
                               -1).reshape(-1, 2))
        st.append(torch.full((h * w,), float(s), device=device))
    return torch.cat(pts), torch.cat(st)


def _ciou_xyxy(a, b, eps=1e-7):
    """CIoU of (..., 4) xyxy boxes paired elementwise (ultralytics
    ``bbox_iou(CIoU=True)``); the aspect term's weight carries no
    gradient."""
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    inter = (torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                         min=0)
             * torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                           min=0))
    aw, ah = ax2 - ax1, ay2 - ay1
    bw, bh = bx2 - bx1, by2 - by1
    union = aw * ah + bw * bh - inter + eps
    iou = inter / union
    cw = torch.maximum(ax2, bx2) - torch.minimum(ax1, bx1)
    chh = torch.maximum(ay2, by2) - torch.minimum(ay1, by1)
    c2 = cw ** 2 + chh ** 2 + eps
    rho2 = (((bx1 + bx2) - (ax1 + ax2)) ** 2
            + ((by1 + by2) - (ay1 + ay2)) ** 2) / 4.0
    v = (4 / math.pi ** 2) * (torch.atan(bw / torch.clamp(bh, min=eps))
                              - torch.atan(aw / torch.clamp(ah, min=eps))) ** 2
    alpha = (v / torch.clamp(v - iou + (1 + eps), min=eps)).detach()
    return iou - (rho2 / c2 + v * alpha)


@torch.no_grad()
def tal_assign(pred_scores, pred_xyxy, anchors, gt_xyxy, gt_cls, gt_valid,
               topk: int = 10, alpha: float = 0.5, beta: float = 6.0,
               eps: float = 1e-9):
    """Task-aligned assignment over a batch. pred_scores (B, A, C) sigmoid
    probabilities, pred_xyxy (B, A, 4), anchors (A, 2), gt_xyxy (B, G, 4),
    gt_cls (B, G) int, gt_valid (B, G) bool. Returns (assigned ground truth
    (B, A) int64, foreground (B, A) bool, normalised alignment (B, A))."""
    B, A, C = pred_scores.shape
    G = gt_xyxy.shape[1]
    ax, ay = anchors[:, 0][None, :, None], anchors[:, 1][None, :, None]
    d_l = ax - gt_xyxy[:, None, :, 0]
    d_t = ay - gt_xyxy[:, None, :, 1]
    d_r = gt_xyxy[:, None, :, 2] - ax
    d_b = gt_xyxy[:, None, :, 3] - ay
    in_gts = torch.minimum(torch.minimum(d_l, d_t),
                           torch.minimum(d_r, d_b)) > eps      # (B, A, G)
    overlaps = torch.clamp(_ciou_xyxy(pred_xyxy[:, :, None, :],
                                      gt_xyxy[:, None, :, :]), min=0.0)
    cls_idx = torch.clamp(gt_cls, 0, C - 1).long()[:, None, :].expand(B, A, G)
    cls_score = torch.gather(pred_scores, 2, cls_idx)          # (B, A, G)
    align = cls_score ** alpha * overlaps ** beta
    cand = in_gts & gt_valid[:, None, :]
    zero = torch.zeros((), dtype=align.dtype, device=align.device)
    align_c = torch.where(cand, align, zero)
    k = min(topk, A)
    kth = torch.topk(align_c.transpose(1, 2), k, dim=-1).values[..., k - 1]
    mask_pos = (align_c >= torch.clamp(kth, min=eps)[:, None, :]) & cand
    n_match = mask_pos.sum(2)
    best = torch.argmax(torch.where(mask_pos, overlaps,
                                    torch.full_like(overlaps, -1.0)), dim=2)
    keep = F.one_hot(best, G).bool() & mask_pos
    mask_pos = torch.where((n_match > 1)[..., None], keep, mask_pos)
    fg = mask_pos.any(2)
    assigned = torch.argmax(mask_pos.to(torch.int32), dim=2)
    pos_align = torch.where(mask_pos, align, zero)
    pos_overlap = torch.where(mask_pos, overlaps, zero)
    g_max_align = pos_align.amax(dim=1)                        # (B, G)
    g_max_ov = pos_overlap.amax(dim=1)
    norm = pos_align * (g_max_ov / torch.clamp(g_max_align, min=eps))[:, None]
    return assigned, fg, norm.amax(dim=2)


def v8_detection_loss(outputs, gt_boxes, gt_valid, input_hw,
                      num_classes: int, reg_max: int = 16,
                      strides=(8, 16, 32), w_box: float = 7.5,
                      w_cls: float = 0.5, w_dfl: float = 1.5):
    """outputs: the per-level raw (B, H, W, 4 * reg_max + C) maps of the
    model's forward; gt_boxes (B, G, 5) [cx, cy, w, h, cls] in input
    pixels; gt_valid (B, G) bool. The call surface of
    ``models/train.py:detection_loss``, so ``train_detector`` drives both
    families. Returns the batch's mean loss."""
    dev = outputs[0].device
    anchors, stride_arr = _anchor_points(input_hw, strides, dev)
    raw = torch.cat([o.float().reshape(o.shape[0], -1, o.shape[-1])
                     for o in outputs], dim=1)                  # (B, A, .)
    B, A = raw.shape[:2]
    proj = torch.arange(reg_max, dtype=torch.float32, device=dev)
    reg = raw[..., :4 * reg_max].reshape(B, A, 4, reg_max)
    dist = (torch.softmax(reg, -1) * proj).sum(-1)               # (B, A, 4)
    ax, ay = anchors[:, 0], anchors[:, 1]
    pred_xyxy = torch.stack([ax - dist[..., 0] * stride_arr,
                             ay - dist[..., 1] * stride_arr,
                             ax + dist[..., 2] * stride_arr,
                             ay + dist[..., 3] * stride_arr], -1)
    cls_logit = raw[..., 4 * reg_max:]
    gt_boxes = gt_boxes.float()
    cx, cy, w, h = gt_boxes[..., :4].unbind(-1)
    gt_xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                          -1)
    gt_cls = gt_boxes[..., 4].to(torch.int32)
    assigned, fg, norm_align = tal_assign(
        torch.sigmoid(cls_logit).detach(), pred_xyxy.detach(), anchors,
        gt_xyxy, gt_cls, gt_valid)

    t_xyxy = torch.gather(gt_xyxy, 1, assigned[..., None].expand(B, A, 4))
    t_cls = torch.gather(gt_cls, 1, assigned).long()
    weight = torch.where(fg, norm_align, torch.zeros_like(norm_align))
    tsum = torch.clamp(weight.sum(1), min=1.0)                  # (B,)

    cls_tgt = F.one_hot(t_cls, num_classes).float() * weight[..., None]
    cls_loss = F.binary_cross_entropy_with_logits(
        cls_logit, cls_tgt, reduction="none").sum((1, 2)) / tsum
    ciou = _ciou_xyxy(pred_xyxy, t_xyxy)
    box_loss = (weight * (1.0 - ciou)).sum(1) / tsum

    td = torch.stack([ax - t_xyxy[..., 0], ay - t_xyxy[..., 1],
                      t_xyxy[..., 2] - ax, t_xyxy[..., 3] - ay],
                     -1) / stride_arr[:, None]
    td = torch.clamp(td, 0.0, reg_max - 1 - 0.01)               # (B, A, 4)
    tl = torch.floor(td)
    wr = td - tl
    wl = 1.0 - wr
    logp = torch.log_softmax(reg, -1)                           # (B, A, 4, R)
    tl_i = tl.long()[..., None]
    lp_l = torch.gather(logp, -1, tl_i)[..., 0]
    lp_r = torch.gather(logp, -1, tl_i + 1)[..., 0]
    dfl = -(wl * lp_l + wr * lp_r)
    dfl_loss = (weight[..., None] * dfl).sum((1, 2)) / (4.0 * tsum)
    return (w_box * box_loss + w_cls * cls_loss + w_dfl * dfl_loss).mean()
