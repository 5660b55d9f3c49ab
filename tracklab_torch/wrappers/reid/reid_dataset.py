"""Keypoint prompt masks for ReID crops (counterpart of
tracklab_tpu.wrappers.reid.reid_dataset, holding
:func:`gaussian_keypoint_masks` only; the ReID set builder waits for
ROADMAP item 6).
"""
from __future__ import annotations

import numpy as np

__all__ = ["gaussian_keypoint_masks"]


def gaussian_keypoint_masks(keypoints_xyc, crop_hw, bbox_ltwh,
                            sigma_frac: float = 0.08):
    """(K, 3) image-frame keypoints -> (K, h, w) gaussian prompt masks in
    crop coordinates (the KPR keypoint prompts): keypoint k mapped into the
    (h, w) crop of ``bbox_ltwh``, a gaussian of sigma ``sigma_frac *
    max(h, w)`` around it, zero where its confidence is <= 0."""
    h, w = crop_hw
    l, t, bw, bh = np.asarray(bbox_ltwh, float)
    kp = np.asarray(keypoints_xyc, float).copy()
    kp[:, 0] = (kp[:, 0] - l) / max(bw, 1e-6) * w
    kp[:, 1] = (kp[:, 1] - t) / max(bh, 1e-6) * h
    ys = np.arange(h)[:, None]
    xs = np.arange(w)[None, :]
    sigma = sigma_frac * max(h, w)
    masks = np.zeros((len(kp), h, w), np.float32)
    for k, (x, y, c) in enumerate(kp):
        if c <= 0:
            continue
        masks[k] = np.exp(-((xs - x) ** 2 + (ys - y) ** 2)
                          / (2 * sigma ** 2))
    return masks
