"""StrongSORT helpers shared with BPBReID-StrongSORT (counterpart of the
helpers of tracklab_tpu.trackers.strongsort). The StrongSORT step itself
is not ported yet.

Functions take a leading video axis: means (V, T, 8), costs (V, D, T),
warps (V, 2, 3).
"""
from __future__ import annotations

import torch

from tracklab_torch.ops.assignment import min_cost_matching
from tracklab_torch.trackers.common import invert_match

__all__ = ["_mean_to_ltrb", "_clamped_matching", "_invert", "_apply_warp"]


def _mean_to_ltrb(mean):
    """xyah KF mean (..., 8) -> ltrb (..., 4)."""
    cx, cy, a, h = mean[..., 0], mean[..., 1], mean[..., 2], mean[..., 3]
    w = a * h
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def _clamped_matching(cost, row_mask, col_mask, max_distance, batched=False):
    """min_cost_matching semantics (linear_assignment.py:55-73) with the
    exact unique-candidate fast path; ``batched=True`` is the cond-free
    form."""
    return min_cost_matching(cost, row_mask, col_mask, max_distance,
                             batched=batched)


def _invert(det2trk, T: int):
    """det -> track map (V, D) to track -> det map (V, T), -1 where free."""
    return invert_match(det2trk, T)


def _apply_warp(mean, warp):
    """Apply a 2x3 affine camera warp per video to track means (V, T, 8)
    (track.py:221-244 camera_update): warp the box corners, refit xyah;
    velocities untouched."""
    ltrb = _mean_to_ltrb(mean)
    one = torch.ones_like(ltrb[..., 0])
    wt = warp.transpose(-1, -2)[..., None, :, :]            # (V, 1, 3, 2)
    p1 = (torch.stack([ltrb[..., 0], ltrb[..., 1], one], dim=-1)[..., None, :]
          @ wt)[..., 0, :]
    p2 = (torch.stack([ltrb[..., 2], ltrb[..., 3], one], dim=-1)[..., None, :]
          @ wt)[..., 0, :]
    w = p2[..., 0] - p1[..., 0]
    h = p2[..., 1] - p1[..., 1]
    cx = p1[..., 0] + w / 2
    cy = p1[..., 1] + h / 2
    a = w / torch.clamp(h, min=1e-6)
    new_pos = torch.stack([cx, cy, a, h], dim=-1)
    return torch.cat([new_pos, mean[..., 4:]], dim=-1)
