"""Host-side coordinate utilities in numpy (the port's own copy of
tracklab_tpu.utils.coordinates, API-compatible with the reference's
tracklab/utils/coordinates.py function zoo).

These operate on single boxes or (N, 4)/(N, K, C) arrays at the DataFrame
boundary; device-side equivalents live in tracklab_torch.ops.boxes and
engine/fused.py:_kp_bbox_ltrb.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "ltwh_to_ltrb", "ltwh_to_xywh", "ltrb_to_ltwh", "ltrb_to_xywh",
    "xywh_to_ltwh", "xywh_to_ltrb", "sanitize_bbox_ltwh",
    "sanitize_bbox_ltrb", "sanitize_keypoints", "clip_bbox_ltwh_to_img_dim",
    "clip_bbox_ltrb_to_img_dim", "clip_keypoints_to_image",
    "round_bbox_coordinates", "bbox_ltwh2ltrb", "generate_bbox_from_keypoints",
    "rescale_keypoints", "kp_img_to_kp_bbox",
]


def _arr(x):
    return np.asarray(x, dtype=np.float64)


def ltwh_to_ltrb(ltwh, image_shape=None):
    """[l, t, w, h] -> [l, t, r, b]; optionally clipped to (W, H)."""
    ltwh = _arr(ltwh)
    out = ltwh.copy()
    out[..., 2:4] = ltwh[..., 0:2] + ltwh[..., 2:4]
    if image_shape is not None:
        out = clip_bbox_ltrb_to_img_dim(out, *image_shape[:2])
    return out


bbox_ltwh2ltrb = ltwh_to_ltrb


def ltwh_to_xywh(ltwh, image_shape=None):
    ltwh = _arr(ltwh)
    out = ltwh.copy()
    out[..., 0:2] = ltwh[..., 0:2] + ltwh[..., 2:4] / 2
    if image_shape is not None:
        ltrb = clip_bbox_ltrb_to_img_dim(ltwh_to_ltrb(ltwh), *image_shape[:2])
        return ltrb_to_xywh(ltrb)
    return out


def ltrb_to_ltwh(ltrb, image_shape=None):
    ltrb = _arr(ltrb)
    if image_shape is not None:
        ltrb = clip_bbox_ltrb_to_img_dim(ltrb, *image_shape[:2])
    out = ltrb.copy()
    out[..., 2:4] = ltrb[..., 2:4] - ltrb[..., 0:2]
    return out


def ltrb_to_xywh(ltrb, image_shape=None):
    ltrb = _arr(ltrb)
    if image_shape is not None:
        ltrb = clip_bbox_ltrb_to_img_dim(ltrb, *image_shape[:2])
    out = ltrb.copy()
    out[..., 0:2] = (ltrb[..., 0:2] + ltrb[..., 2:4]) / 2
    out[..., 2:4] = ltrb[..., 2:4] - ltrb[..., 0:2]
    return out


def xywh_to_ltwh(xywh, image_shape=None):
    xywh = _arr(xywh)
    out = xywh.copy()
    out[..., 0:2] = xywh[..., 0:2] - xywh[..., 2:4] / 2
    if image_shape is not None:
        return ltrb_to_ltwh(ltwh_to_ltrb(out, image_shape))
    return out


def xywh_to_ltrb(xywh, image_shape=None):
    xywh = _arr(xywh)
    out = xywh.copy()
    out[..., 0:2] = xywh[..., 0:2] - xywh[..., 2:4] / 2
    out[..., 2:4] = out[..., 0:2] + xywh[..., 2:4]
    if image_shape is not None:
        out = clip_bbox_ltrb_to_img_dim(out, *image_shape[:2])
    return out


def clip_bbox_ltrb_to_img_dim(ltrb, img_w, img_h):
    out = _arr(ltrb).copy()
    out[..., 0] = np.clip(out[..., 0], 0, img_w)
    out[..., 1] = np.clip(out[..., 1], 0, img_h)
    out[..., 2] = np.clip(out[..., 2], 0, img_w)
    out[..., 3] = np.clip(out[..., 3], 0, img_h)
    return out


def clip_bbox_ltwh_to_img_dim(ltwh, img_w, img_h):
    return ltrb_to_ltwh(
        clip_bbox_ltrb_to_img_dim(ltwh_to_ltrb(ltwh), img_w, img_h))


def sanitize_bbox_ltwh(bbox, image_shape=None, rounded=False):
    """Clamp a ltwh box to image bounds and optionally round to int."""
    bbox = _arr(bbox)
    if image_shape is not None:
        bbox = clip_bbox_ltwh_to_img_dim(bbox, *image_shape[:2])
    if rounded:
        return np.round(bbox).astype(int)
    return bbox


def sanitize_bbox_ltrb(bbox, image_shape=None, rounded=False):
    bbox = _arr(bbox)
    if image_shape is not None:
        bbox = clip_bbox_ltrb_to_img_dim(bbox, *image_shape[:2])
    if rounded:
        return np.round(bbox).astype(int)
    return bbox


def round_bbox_coordinates(bbox):
    return np.round(_arr(bbox)).astype(int)


def sanitize_keypoints(keypoints, image_shape=None, rounded=False):
    """Clamp (K, 2/3) keypoints into the image; confidence col untouched."""
    keypoints = _arr(keypoints).copy()
    if image_shape is not None:
        keypoints[..., 0] = np.clip(keypoints[..., 0], 0, image_shape[0] - 1)
        keypoints[..., 1] = np.clip(keypoints[..., 1], 0, image_shape[1] - 1)
    if rounded:
        keypoints[..., :2] = np.round(keypoints[..., :2])
    return keypoints


clip_keypoints_to_image = sanitize_keypoints


def generate_bbox_from_keypoints(keypoints, extension_factor,
                                 image_shape=None):
    """ltwh box around visible keypoints, padded by (top, bottom, sides)
    fractions of the raw box height — mirrors the RTMO bottom-up path
    (reference: tracklab/utils/coordinates.py bbox-from-keypoints)."""
    keypoints = _arr(keypoints)
    vis = keypoints[..., 2] > 0 if keypoints.shape[-1] > 2 else \
        np.ones(keypoints.shape[:-1], bool)
    pts = keypoints[vis][:, :2] if vis.any() else keypoints[..., :2]
    lt = pts.min(axis=0)
    rb = pts.max(axis=0)
    w, h = rb - lt
    top, bottom, sides = extension_factor
    l = lt[0] - sides * h
    t = lt[1] - top * h
    r = rb[0] + sides * h
    b = rb[1] + bottom * h
    ltrb = np.array([l, t, r, b])
    if image_shape is not None:
        ltrb = clip_bbox_ltrb_to_img_dim(ltrb, *image_shape[:2])
    return ltrb_to_ltwh(ltrb)


def rescale_keypoints(keypoints, original_size, new_size):
    """Rescale (…, >=2) keypoints from original (W, H) to new (W, H)."""
    keypoints = _arr(keypoints).copy()
    keypoints[..., 0] *= new_size[0] / original_size[0]
    keypoints[..., 1] *= new_size[1] / original_size[1]
    return keypoints


def kp_img_to_kp_bbox(kp_xyc_img, bbox_ltwh):
    """Image-frame keypoints -> bbox-local frame; out-of-box kps get c=0."""
    kp = _arr(kp_xyc_img).copy()
    l, t, w, h = _arr(bbox_ltwh)[:4]
    kp[..., 0] -= l
    kp[..., 1] -= t
    if kp.shape[-1] > 2:
        inside = ((kp[..., 0] >= 0) & (kp[..., 0] <= w)
                  & (kp[..., 1] >= 0) & (kp[..., 1] <= h))
        kp[..., 2] = np.where(inside, kp[..., 2], 0.0)
    return kp
