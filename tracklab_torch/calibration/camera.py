"""Differentiable broadcast-camera model in PyTorch (counterpart of
tracklab_tpu.calibration.camera).

Pan / tilt / roll, focal length and position project z = 0 pitch points
into the image. Every function takes cameras with leading batch dimensions
(each field shaped ``(...)``, position ``(..., 3)``), so TVCalib's
hypotheses x frames descend as one batch where the JAX package vmaps; a
single camera is the empty batch shape.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["CameraParams", "camera_matrix", "project_points",
           "backproject_to_pitch"]


class CameraParams(NamedTuple):
    """Angles in radians; position in pitch metres, z the height above the
    pitch (world z up). ``distortion`` holds radial (k1, k2); ``None`` means
    no distortion."""
    pan: torch.Tensor        # (...)
    tilt: torch.Tensor       # (...)
    roll: torch.Tensor       # (...)
    focal: torch.Tensor      # (...) pixels
    position: torch.Tensor   # (..., 3) [x, y, z(height)]
    principal: torch.Tensor  # (..., 2) [cx, cy] pixels
    distortion: torch.Tensor | None = None  # (..., 2) (k1, k2)


def _rotation(pan, tilt, roll):
    """World -> camera rotation (..., 3, 3), rows camera right / down /
    forward. The optical axis is f = [sin(pan) sin(tilt), -cos(pan)
    sin(tilt), -cos(tilt)]: tilt 0 looks straight down, pi/2 horizontal;
    pan 0 looks along world -y; roll spins the image about f."""
    st, ct = torch.sin(tilt), torch.cos(tilt)
    sp, cp = torch.sin(pan), torch.cos(pan)
    f = torch.stack([sp * st, -cp * st, -ct], dim=-1)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=f.dtype, device=f.device)
    r0 = torch.linalg.cross(f, up.expand_as(f))
    r0 = r0 / torch.clamp(torch.linalg.vector_norm(r0, dim=-1,
                                                   keepdim=True), min=1e-8)
    d0 = torch.linalg.cross(f, r0)
    cr, sr = torch.cos(roll)[..., None], torch.sin(roll)[..., None]
    r = cr * r0 + sr * d0
    d = -sr * r0 + cr * d0
    return torch.stack([r, d, f], dim=-2)


def camera_matrix(cam: CameraParams):
    """(..., 3, 4) projection P = K [R | -R C]."""
    R = _rotation(cam.pan, cam.tilt, cam.roll)
    zero, one = torch.zeros_like(cam.focal), torch.ones_like(cam.focal)
    K = torch.stack([
        torch.stack([cam.focal, zero, cam.principal[..., 0]], dim=-1),
        torch.stack([zero, cam.focal, cam.principal[..., 1]], dim=-1),
        torch.stack([zero, zero, one], dim=-1)], dim=-2)
    t = -(R @ cam.position[..., None])
    return K @ torch.cat([R, t], dim=-1)


def project_points(cam: CameraParams, points3d):
    """(N, 3) world points -> ((..., N, 2) pixels, (..., N) in-front mask).
    Radial distortion (k1, k2) applies in normalised camera coordinates."""
    R = _rotation(cam.pan, cam.tilt, cam.roll)
    xc = (points3d - cam.position[..., None, :]) @ R.transpose(-1, -2)
    z = xc[..., 2]
    zsafe = torch.where(torch.abs(z) > 1e-8, z, torch.full_like(z, 1e-8))
    xn = xc[..., 0] / zsafe
    yn = xc[..., 1] / zsafe
    if cam.distortion is not None:
        r2 = xn * xn + yn * yn
        k1 = cam.distortion[..., 0:1]
        k2 = cam.distortion[..., 1:2]
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        xn = xn * radial
        yn = yn * radial
    f = cam.focal[..., None]
    px = f * xn + cam.principal[..., 0:1]
    py = f * yn + cam.principal[..., 1:2]
    return torch.stack([px, py], dim=-1), z > 0


def backproject_to_pitch(cam: CameraParams, pixels):
    """(N, 2) pixels -> (N, 2) coordinates on the pitch (z = 0) plane,
    through the inverse of P restricted to that plane: the map from a box's
    bottom edge to ``bbox_pitch``."""
    P = camera_matrix(cam)
    H = P[..., [0, 1, 3]]
    Hinv = torch.linalg.inv(H)
    ph = torch.cat([pixels, torch.ones_like(pixels[..., :1])], dim=-1)
    w = ph @ Hinv.transpose(-1, -2)
    den = w[..., 2:]
    return w[..., :2] / torch.where(torch.abs(den) > 1e-8, den,
                                    torch.full_like(den, 1e-8))
