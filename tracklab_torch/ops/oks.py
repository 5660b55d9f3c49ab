"""Object Keypoint Similarity in PyTorch (counterpart of
tracklab_tpu.ops.oks): per-keypoint kappa falloff, the scale from the
visible keypoints' box area with a 45-degree-rotated fallback, the
similarity normalised by the reference's visible count. Functions take
leading batch (video) axes.
"""
from __future__ import annotations

import functools
import math

import torch

__all__ = ["COCO_KAPPA", "oks_similarity", "oks_matrix"]

# per-keypoint falloff constants of the COCO-17 skeleton
COCO_KAPPA = (0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
              0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089)


def _span(a, visible, big=1e9):
    """(max - min) over the keypoint axis of ``a`` (..., K), over the
    visible keypoints only and over all of them."""
    vis_span = (torch.where(visible, a, -big).amax(-1)
                - torch.where(visible, a, big).amin(-1))
    return vis_span, a.amax(-1) - a.amin(-1)


def _area_scale(kp, visible):
    """Scale factor from reference keypoints ``kp`` (..., K, 3); NaN for a
    degenerate skeleton."""
    vx, tx = _span(kp[..., 0], visible)
    vy, ty = _span(kp[..., 1], visible)
    area, total_area = vx * vy, tx * ty
    c = s = math.sqrt(0.5)
    rx = c * kp[..., 0] - s * kp[..., 1]
    ry = s * kp[..., 0] + c * kp[..., 1]
    rvx, rtx = _span(rx, visible)
    rvy, rty = _span(ry, visible)
    area45, total45 = rvx * rvy, rtx * rty
    inf = torch.full_like(area, float("inf"))
    r1 = torch.where(area > 0.1, total_area / area, inf)
    r2 = torch.where(area45 > 0.1, total45 / area45, inf)
    factor = torch.clamp(torch.sqrt(torch.minimum(r1, r2)), max=5.0)
    scale = torch.sqrt(torch.clamp(area, min=0.0)) * factor
    return torch.where(scale < 0.1, torch.full_like(scale, float("nan")),
                       scale)


@functools.lru_cache(maxsize=None)
def _kappa_const(K, dtype, device):
    """The default falloffs for K keypoints, built once per dtype and
    device: a tensor made from Python numbers on the card is a
    host-to-device copy, which waits for the stream."""
    kappa = COCO_KAPPA[:K] if K <= len(COCO_KAPPA) else (0.08,) * K
    return torch.tensor(kappa, dtype=dtype, device=device)


def _kappa(K, dtype, device, kappa=None):
    if kappa is None:
        return _kappa_const(K, dtype, device)
    return torch.as_tensor(kappa, dtype=dtype, device=device)


def oks_similarity(kp, candidates, kappa=None):
    """OKS of reference keypoints (..., K, 3) vs candidates (..., M, K, 3)
    -> (..., M); NaN when the reference skeleton is degenerate."""
    K = kp.shape[-2]
    kap = _kappa(K, kp.dtype, kp.device, kappa)
    visible = kp[..., 2] > 0.0
    scale = _area_scale(kp, visible)[..., None, None]
    d2 = ((kp[..., None, :, 0] - candidates[..., 0]) ** 2
          + (kp[..., None, :, 1] - candidates[..., 1]) ** 2)
    per_kp = (torch.exp(-d2 / (2 * scale ** 2 * kap ** 2))
              * visible[..., None, :].to(kp.dtype))
    n_vis = torch.clamp(visible.sum(-1), min=1)[..., None]
    return per_kp.sum(-1) / n_vis


def oks_matrix(track_kps, det_kps, kappa=None):
    """(..., T, K, 3) track keypoints x (..., D, K, 3) detections ->
    (..., T, D) OKS."""
    return oks_similarity(track_kps, det_kps[..., None, :, :, :], kappa)
