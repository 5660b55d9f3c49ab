"""Non-maximum suppression with fixed output shapes (counterpart of
tracklab_tpu.ops.nms).

Score-sorted greedy suppression over a fixed top-K candidate set,
vectorised over the batch; the K-step greedy loop stays a loop of small
tensor ops, as in the JAX package, which has no kernel here. Ties follow the
JAX order: ``jnp.argsort`` is stable and ``lax.top_k`` puts the lower index
first, so both become stable sorts (``torch.topk`` promises no tie order on
CUDA).
"""
from __future__ import annotations

import torch

from tracklab_torch.ops.boxes import pairwise_iou, xywh_to_ltrb

__all__ = ["nms", "batched_nms", "postprocess_detections"]


def nms(ltrb, scores, iou_threshold: float = 0.65, max_out: int = 128):
    """Greedy NMS over (B, N, 4) boxes and (B, N) scores (a single image
    may drop the batch axis). Returns the keep mask, same leading shape.
    Invalid candidates should carry score <= 0."""
    if scores.dim() == 1:
        return nms(ltrb[None], scores[None], iou_threshold, max_out)[0]
    n = scores.shape[1]
    order = torch.sort(-scores, dim=1, stable=True).indices
    boxes_sorted = torch.gather(ltrb, 1, order[..., None].expand(-1, -1, 4))
    scores_sorted = torch.gather(scores, 1, order)
    over = pairwise_iou(boxes_sorted, boxes_sorted) > iou_threshold
    keep = torch.zeros_like(scores_sorted, dtype=torch.bool)
    for i in range(n):
        # suppress i if a kept higher-scoring (earlier) box overlaps it
        sup = (keep[:, :i] & over[:, i, :i]).any(dim=1)
        keep[:, i] = (scores_sorted[:, i] > 0) & ~sup
    kept_rank = torch.cumsum(keep.to(torch.int32), 1) - 1
    keep = keep & (kept_rank < max_out)
    return torch.zeros_like(keep).scatter_(1, order, keep)


def batched_nms(ltrb, scores, class_ids, iou_threshold: float = 0.65,
                max_out: int = 128, class_agnostic: bool = False):
    """Per-class NMS via the coordinate-offset trick, per image."""
    if class_agnostic:
        return nms(ltrb, scores, iou_threshold, max_out)
    flat = ltrb.flatten(1)
    span = flat.amax(dim=1) - flat.amin(dim=1) + 1.0
    offset = class_ids.to(ltrb.dtype)[..., None] * span[:, None, None]
    return nms(ltrb + offset, scores, iou_threshold, max_out)


def postprocess_detections(decoded, conf_threshold: float = 0.01,
                           iou_threshold: float = 0.65, max_out: int = 128,
                           class_agnostic: bool = True):
    """YOLOX-style decode -> detections, batched over images.

    decoded: (B, A, 5+C) [xywh, obj, cls...] from ``decode_outputs``.
    Returns a dict of (B, max_out) tensors: ltrb, score, cls (int32),
    valid, with kept rows compacted to the front in score order.
    """
    B, A, _ = decoded.shape
    xywh = decoded[..., :4]
    obj = decoded[..., 4]
    cls_scores = decoded[..., 5:]
    cls_id = torch.argmax(cls_scores, dim=-1)
    score = obj * cls_scores.amax(dim=-1)
    ltrb = xywh_to_ltrb(xywh)
    k = min(4 * max_out, A)
    cand = torch.where(score >= conf_threshold, score,
                       torch.zeros_like(score))
    top_score, top_idx = torch.sort(cand, dim=1, descending=True,
                                    stable=True)
    top_score, top_idx = top_score[:, :k], top_idx[:, :k]
    top_ltrb = torch.gather(ltrb, 1, top_idx[..., None].expand(-1, -1, 4))
    top_cls = torch.gather(cls_id, 1, top_idx)
    keep = batched_nms(top_ltrb, top_score, top_cls, iou_threshold, max_out,
                       class_agnostic)
    rank = torch.cumsum(keep.to(torch.int64), 1) - 1
    tgt = torch.where(keep, rank, max_out)
    dev = decoded.device

    def compact(src, fill_shape, dtype):
        out = torch.zeros((B, max_out + 1) + fill_shape, dtype=dtype,
                          device=dev)
        idx = tgt.reshape(tgt.shape + (1,) * len(fill_shape)).expand_as(src)
        return out.scatter_(1, idx, src.to(dtype))[:, :max_out]

    return dict(ltrb=compact(top_ltrb, (4,), ltrb.dtype),
                score=compact(top_score, (), score.dtype),
                cls=compact(top_cls, (), torch.int32),
                valid=compact(keep, (), torch.bool))
