"""Device-side crop preprocessing (counterpart of
tracklab_tpu.models.preprocess) and the ImageNet normalisation constants of
the ReID models (the port's own copy of ``IMAGENET_MEAN``/``IMAGENET_STD``
from tracklab_tpu.wrappers.reid.osnet_api, in the 0-255 pixel range).
"""
from __future__ import annotations

import torch

__all__ = ["crop_resize", "IMAGENET_MEAN", "IMAGENET_STD"]

IMAGENET_MEAN = (0.485 * 255, 0.456 * 255, 0.406 * 255)
IMAGENET_STD = (0.229 * 255, 0.224 * 255, 0.225 * 255)


def _taps(lo, hi, n_out: int, n_src: int):
    """Sample positions along one axis for boxes spanning [lo, hi]
    (..., N): the two clamped source indices (int64) and the clamped
    weight of the second, each (..., N, n_out), in the JAX gather's order
    of operations."""
    ar = torch.arange(n_out, dtype=torch.float32, device=lo.device) + 0.5
    s = lo[..., None] + (hi - lo)[..., None] * ar / n_out - 0.5
    s0 = torch.clamp(torch.floor(s).to(torch.int64), 0, n_src - 1)
    s1 = torch.clamp(s0 + 1, 0, n_src - 1)
    w = torch.clamp(s - s0.to(torch.float32), 0.0, 1.0)
    return s0, s1, w


def crop_resize(images, boxes_ltrb, out_h: int, out_w: int):
    """Bilinear crop-and-resize as the exact 4-tap gather of the JAX
    package's ``crop_resize``: ``images`` (..., H, W, C) with ``boxes_ltrb``
    (..., N, 4) sharing the leading (frame) axes -> (..., N, out_h, out_w,
    C) float32. Sample centres ``lo + (hi - lo) * (i + 0.5) / n - 0.5``,
    source indices clamped to the image, weights clamped to [0, 1]."""
    lead = images.shape[:-3]
    H, W, C = images.shape[-3:]
    img = images.reshape((-1, H * W, C)).float()
    box = boxes_ltrb.reshape((img.shape[0], -1, 4)).float()
    y0, y1, wy = _taps(box[..., 1], box[..., 3], out_h, H)   # (F, N, oh)
    x0, x1, wx = _taps(box[..., 0], box[..., 2], out_w, W)   # (F, N, ow)

    def tap(yi, xi):
        idx = (yi[..., :, None] * W + xi[..., None, :])      # (F, N, oh, ow)
        flat = idx.reshape(img.shape[0], -1, 1).expand(-1, -1, C)
        return img.gather(1, flat).reshape(idx.shape + (C,))

    wx = wx[..., None, :, None]
    wy = wy[..., :, None, None]
    top = tap(y0, x0) * (1 - wx) + tap(y0, x1) * wx
    bot = tap(y1, x0) * (1 - wx) + tap(y1, x1) * wx
    out = top * (1 - wy) + bot * wy
    return out.reshape(lead + out.shape[1:])
