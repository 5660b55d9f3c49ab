"""TVCalib-style camera calibration by batched gradient descent in PyTorch
(counterpart of tracklab_tpu.calibration.tvcalib).

Per-frame camera parameters descend on the reprojection distance between
observed pitch-line points and the projected pitch template. Every
camera-type hypothesis and every frame of a batch descend together as one
(H, B, 9) tensor of z-scored latents on the device, through autograd, with
no host read inside the loop; the argmin over hypotheses per frame picks
the camera (the reference's per-type runs fused by argmin).

The optimiser is optax's ``adamw`` under ``cosine_onecycle_schedule``, as
the JAX package chains it through ``multi_transform``: two parameter
groups, the camera latents (peak lr ``cfg.lr``, pct_start 0.5) and the
lens-distortion latents (peak ``cfg.lr_dist``, pct_start 0.33), each with
its own schedule, moments and step count. Both the schedule and the update
are optax's formulas, written out (``torch.optim.lr_scheduler.OneCycleLR``
ends its phases one step earlier and moves Adam's beta1 by default).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from tracklab_torch.calibration.cam_distr import priors_array
from tracklab_torch.calibration.camera import CameraParams, project_points
from tracklab_torch.calibration.pitch import pitch_segments
from tracklab_torch.device import resolve_device

__all__ = ["TVCalibConfig", "optimize_cameras", "unpack_camera",
           "onecycle_lrs"]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8   # optax.adamw's defaults


@dataclass(frozen=True)
class TVCalibConfig:
    steps: int = 300
    lr: float = 0.05           # camera-latent OneCycle peak
    lr_dist: float = 1e-3      # distortion-latent peak
    weight_decay: float = 0.01
    image_width: int = 1920
    image_height: int = 1080
    max_points_per_segment: int = 32
    # camera-type hypotheses optimised in parallel and argmin-fused; one
    # entry is the reference's one-subset run
    camera_types: tuple = ("main_center",)
    sigma_scale: float = 1.96
    lens_distortion: bool = False


def _build_template(cfg, device=None):
    segs = pitch_segments()
    names = sorted(segs)
    pts = np.stack([segs[n] for n in names])      # (S, P, 3)
    return names, torch.as_tensor(pts, dtype=torch.float32, device=device)


def onecycle_lrs(steps: int, peak: float, pct_start: float,
                 div_factor: float = 25.0,
                 final_div_factor: float = 1e4) -> list:
    """optax.cosine_onecycle_schedule(steps, peak, pct_start) at counts
    0 .. steps - 1: cosine from peak/div up to peak over
    ``int(pct_start * steps)`` steps, then down to
    peak/(div * final_div) at ``steps``."""
    bounds = [0, int(pct_start * steps), int(steps)]
    init = peak / div_factor
    values = [init, init * div_factor,
              init * div_factor / (div_factor * final_div_factor)]
    out = []
    for t in range(steps):
        k = 0 if t < bounds[1] else 1
        pct = (t - bounds[k]) / (bounds[k + 1] - bounds[k])
        start, end = values[k], values[k + 1]
        out.append(end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1))
    return out


def unpack_camera(z, priors, cfg) -> CameraParams:
    """z-scored latents (..., 9) and per-type priors (..., 9, 2) ->
    CameraParams with batch shape (...). Latent order
    ``cam_distr.PARAM_ORDER``; height = -c_z (z up here, down in the
    reference) and focal = (W / 2) / tan(aov / 2)."""
    p = priors[..., 0] + z * priors[..., 1]
    pan, tilt, roll, aov, c_x, c_y, c_z, k1, k2 = p.unbind(-1)
    aov = torch.clamp(aov, 0.02, math.pi * 0.95)
    focal = (cfg.image_width / 2.0) / torch.tan(aov / 2.0)
    principal = torch.tensor([cfg.image_width / 2, cfg.image_height / 2],
                             dtype=p.dtype, device=p.device)
    return CameraParams(
        pan=pan, tilt=tilt, roll=roll, focal=focal,
        position=torch.stack([c_x, c_y, -c_z], dim=-1),
        principal=principal.expand(pan.shape + (2,)),
        distortion=torch.stack([k1, k2], dim=-1))


def _frame_loss(z, obs_pts, obs_seg, obs_valid, priors, template, cfg):
    """NDC reprojection distance of each observed point to the nearest
    projected template point of its segment, averaged over the valid
    points, plus a weak prior on the latents.

    Batched: z (..., 9), priors broadcastable to (..., 9, 2), observations
    (..., N, 2) / (..., N) with the same batch shape -> losses (...)."""
    cam = unpack_camera(z, priors, cfg)
    S, P, _ = template.shape
    proj, in_front = project_points(cam, template.reshape(S * P, 3))
    wh = torch.tensor([cfg.image_width, cfg.image_height],
                      dtype=proj.dtype, device=proj.device)
    ndc = (proj / wh).reshape(proj.shape[:-2] + (S, P, 2))
    in_front = in_front.reshape(in_front.shape[:-1] + (S, P))
    obs_ndc = obs_pts / wh
    # each observed point's segment: gather (..., N, P, ...) along S
    idx = obs_seg.long().expand(ndc.shape[:-3] + obs_seg.shape[-1:])
    seg_pts = torch.gather(
        ndc, -3, idx[..., None, None].expand(idx.shape + (P, 2)))
    seg_front = torch.gather(in_front, -2,
                             idx[..., None].expand(idx.shape + (P,)))
    d = torch.linalg.vector_norm(seg_pts - obs_ndc[..., None, :], dim=-1)
    d = torch.where(seg_front, d, torch.full_like(d, 1e3))
    # amin spreads the gradient evenly over ties, as jnp.min does
    dmin = torch.amin(d, dim=-1)
    dmin = torch.minimum(dmin, torch.full_like(dmin, 2.0))
    denom = torch.clamp(obs_valid.sum(-1).to(dmin.dtype), min=1.0)
    loss = torch.where(obs_valid, dmin, torch.zeros_like(dmin)).sum(-1) \
        / denom
    return loss + 1e-4 * (z ** 2).sum(-1)


def _pack_observations(observations, names, cfg):
    name_to_idx = {n: i for i, n in enumerate(names)}
    B = len(observations)
    N = cfg.max_points_per_segment * len(names)
    pts = np.zeros((B, N, 2), np.float32)
    seg = np.zeros((B, N), np.int64)
    valid = np.zeros((B, N), bool)
    for b, obs in enumerate(observations):
        k = 0
        for nme, p in obs.items():
            if nme not in name_to_idx or len(p) == 0:
                continue
            p = np.asarray(p, np.float32)[: cfg.max_points_per_segment]
            m = len(p)
            if k + m > N:
                break
            pts[b, k:k + m] = p
            seg[b, k:k + m] = name_to_idx[nme]
            valid[b, k:k + m] = True
            k += m
    return pts, seg, valid


class _AdamW:
    """optax.adamw on one parameter group: moments, its step count and its
    learning rates per step."""

    def __init__(self, param, lrs, weight_decay):
        self.p, self.lrs, self.wd = param, lrs, weight_decay
        self.mu = torch.zeros_like(param)
        self.nu = torch.zeros_like(param)
        self.count = 0

    @torch.no_grad()
    def step(self, grad):
        lr = self.lrs[self.count]
        self.count += 1
        self.mu.mul_(_B1).add_(grad, alpha=1 - _B1)
        self.nu.mul_(_B2).add_(grad * grad, alpha=1 - _B2)
        mu_hat = self.mu / (1 - _B1 ** self.count)
        nu_hat = self.nu / (1 - _B2 ** self.count)
        update = mu_hat / (torch.sqrt(nu_hat) + _EPS) + self.wd * self.p
        self.p.add_(update * -lr)


def optimize_cameras(observations, cfg: TVCalibConfig = TVCalibConfig(),
                     init_latents=None, device=None):
    """Calibrate a batch of frames with per-type hypothesis fusion on
    ``device`` (``cuda`` unless told otherwise).

    ``observations``: a list (length B) of dicts segment name -> (N_i, 2)
    pixel points of detected pitch lines. ``init_latents`` optionally
    warm-starts the descent: (B, 9) (broadcast over hypotheses) or (H, B, 9)
    z-scored latents. Returns (per-frame camera dicts, with the reference's
    ``to_json_parameters`` names plus 'camera' (CameraParams on the CPU),
    'camera_type', 'latent' and 'hypothesis_losses'; and the (B,) selected
    NDC errors)."""
    dev = resolve_device(device)
    names, template = _build_template(cfg, dev)
    pts, seg, valid = _pack_observations(observations, names, cfg)
    B, H = len(observations), len(cfg.camera_types)
    priors = torch.as_tensor(priors_array(
        cfg.camera_types, cfg.sigma_scale,
        lens_distortion=cfg.lens_distortion), device=dev)    # (H, 9, 2)
    if init_latents is not None:
        zi = np.asarray(init_latents, np.float32)
        if zi.ndim == 2:
            zi = np.broadcast_to(zi, (H,) + zi.shape)
        z0 = torch.as_tensor(np.ascontiguousarray(zi), device=dev)
    else:
        z0 = torch.zeros((H, B, 9), device=dev)
    z_cam = z0[..., :7].clone().requires_grad_(True)
    z_dist = z0[..., 7:].clone().requires_grad_(True)
    opts = (_AdamW(z_cam, onecycle_lrs(cfg.steps, cfg.lr, 0.5),
                   cfg.weight_decay),
            _AdamW(z_dist, onecycle_lrs(cfg.steps, cfg.lr_dist, 0.33),
                   cfg.weight_decay))
    obs = (torch.as_tensor(pts, device=dev), torch.as_tensor(seg, device=dev),
           torch.as_tensor(valid, device=dev))
    pri = priors[:, None]                                    # (H, 1, 9, 2)

    def losses_of(zc, zd):
        return _frame_loss(torch.cat([zc, zd], dim=-1), *obs, pri,
                           template, cfg)                    # (H, B)

    for _ in range(cfg.steps):
        g_cam, g_dist = torch.autograd.grad(losses_of(z_cam, z_dist).sum(),
                                            (z_cam, z_dist))
        opts[0].step(g_cam)
        opts[1].step(g_dist)
    with torch.no_grad():
        final = losses_of(z_cam, z_dist)
        best = torch.argmin(final, dim=0)                   # (B,)
        zfull = torch.cat([z_cam, z_dist], dim=-1)
        ar = torch.arange(B, device=dev)
        cam = unpack_camera(zfull[best, ar], priors[best], cfg)
        cam = CameraParams(*(t.cpu() for t in cam))
    zfull, final, best = (t.detach().cpu().numpy() for t in
                          (zfull, final, best))
    cams, err = [], np.zeros(B, np.float32)
    for b in range(B):
        h = int(best[b])
        err[b] = final[h, b]
        one = CameraParams(*(t[b] for t in cam))
        cams.append({
            "pan_degrees": float(torch.rad2deg(one.pan)),
            "tilt_degrees": float(torch.rad2deg(one.tilt)),
            "roll_degrees": float(torch.rad2deg(one.roll)),
            "x_focal_length": float(one.focal),
            "y_focal_length": float(one.focal),
            "principal_point": [cfg.image_width / 2, cfg.image_height / 2],
            "position_meters": [float(v) for v in one.position],
            "radial_distortion": [float(one.distortion[0]),
                                  float(one.distortion[1])],
            "camera_type": cfg.camera_types[h],
            "camera": one,
            "latent": zfull[h, b],
            "hypothesis_losses": {ct: float(final[i, b])
                                  for i, ct in enumerate(cfg.camera_types)},
        })
    return cams, err
