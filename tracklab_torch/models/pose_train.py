"""Top-down pose training in PyTorch (counterpart of
tracklab_tpu.models.pose_train): gaussian target heatmaps and a masked MSE
on the sigmoided heatmaps of ``models/pose.py:TopDownPose`` (the
SimpleBaseline objective).

The step is ``models/train.py``'s shape: the state holds the model (its
parameters and BN statistics) and a ``torch.optim`` optimizer; one forward
in ``train()`` mode (BN on the batch's statistics, no CSPLayer on kernel K3),
the loss, its backward and one optimizer step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["gaussian_heatmaps", "pose_loss", "make_pose_train_step",
           "create_pose_train_state", "PoseTrainState"]


class PoseTrainState(NamedTuple):
    """The model, its optimizer and the count of steps taken."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int


def create_pose_train_state(model, tx) -> PoseTrainState:
    """``tx``: a callable from parameters to a ``torch.optim`` optimizer,
    e.g. ``functools.partial(torch.optim.Adam, lr=1e-3)`` for
    ``optax.adam(1e-3)``."""
    return PoseTrainState(model, tx(model.parameters()), 0)


def gaussian_heatmaps(kp_xyc, hm_hw, crop_hw, sigma: float = 2.0):
    """(..., K, 3) crop-frame keypoints -> (..., H, W, K) gaussian targets
    at heatmap resolution; a keypoint of confidence <= 0 gives a zero map."""
    H, W = hm_hw
    sy, sx = H / crop_hw[0], W / crop_hw[1]
    kp = kp_xyc.float()
    ys = torch.arange(H, dtype=torch.float32, device=kp.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=kp.device)[None, :]
    kx = (kp[..., 0] * sx)[..., None, None]
    ky = (kp[..., 1] * sy)[..., None, None]
    vis = (kp[..., 2] > 0).float()[..., None, None]
    d2 = (xs - kx) ** 2 + (ys - ky) ** 2                    # (..., K, H, W)
    hm = torch.exp(-d2 / (2 * sigma ** 2)) * vis
    return hm.movedim(-3, -1)


def pose_loss(pred_logits, kp_xyc, crop_hw, sigma: float = 2.0):
    """Masked MSE of the sigmoided heatmaps (B, H, W, K) against the
    targets of keypoints (B, K, 3), averaged over the visible keypoints."""
    B, H, W, K = pred_logits.shape
    targets = gaussian_heatmaps(kp_xyc, (H, W), crop_hw, sigma)
    pred = torch.sigmoid(pred_logits.float())
    vis = (kp_xyc[..., 2] > 0).float()                      # (B, K)
    per_kp = ((pred - targets) ** 2).mean(dim=(1, 2))        # (B, K)
    return (per_kp * vis).sum() / torch.clamp(vis.sum(), min=1.0)


def make_pose_train_step(crop_hw):
    """Returns ``train_step(state, batch) -> (state, loss)``. ``batch``:
    ``crops`` (B, H, W, 3) f32 on the model's device (the model's input
    domain) and ``keypoints`` (B, K, 3) in crop pixels. The gradients stay
    in each parameter's ``.grad`` until the next step."""

    def train_step(state: PoseTrainState, batch):
        model, opt = state.model, state.optimizer
        model.train()
        loss = pose_loss(model(batch["crops"]), batch["keypoints"], crop_hw)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return state._replace(step=state.step + 1), loss.detach()

    return train_step
