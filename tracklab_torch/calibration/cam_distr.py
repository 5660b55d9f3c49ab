"""Per-camera-type parameter distributions, the TVCalib priors
(counterpart of tracklab_tpu.calibration.cam_distr, kept as the port's own
copy).

The five camera types' min/max tables and the lens-distortion distribution,
with the reference's mean/std derivation (mean and std of a linspace over
[vmin, vmax], the std scaled by the confidence factor).

Reference coordinates: x along the pitch length, y positive toward the main
tribune, z DOWN (camera height = -c_z). The port's camera model
(calibration/camera.py) uses z UP; :func:`priors_array` returns the
reference values as they are, and ``tvcalib.unpack_camera`` maps c_z -> -z
and aov -> focal = (image_width / 2) / tan(aov / 2).
"""
from __future__ import annotations

from math import pi

import numpy as np

__all__ = ["CAMERA_TYPES", "mean_std_with_confidence_interval",
           "get_cam_distr", "get_dist_distr", "priors_array",
           "PARAM_ORDER"]

CAMERA_TYPES = ("main_center", "main_left", "main_right",
                "main_behind", "main_tribune")

# latent ordering used by tvcalib.py (7 camera + 2 lens dims)
PARAM_ORDER = ("pan", "tilt", "roll", "aov", "c_x", "c_y", "c_z",
               "k1", "k2")

# minmax tables, verbatim from cam_distr/tv_main_*.py
_MINMAX = {
    "main_center": dict(
        pan=(-pi / 4, pi / 4), tilt=(pi / 4, pi / 2),
        roll=(-pi / 18, pi / 18), aov=(pi / 22, pi / 2),
        c_x=(-12.0, 12.0), c_y=(40.0, 110.0), c_z=(-40.0, -5.0)),
    "main_left": dict(
        pan=(-pi / 4, pi / 4), tilt=(pi / 4, pi / 2),
        roll=(-pi / 18, pi / 18), aov=(pi / 22, pi / 2),
        c_x=(-36 - 16.5, -36 + 16.5), c_y=(40.0, 110.0),
        c_z=(-40.0, -5.0)),
    "main_right": dict(
        pan=(-pi / 4, pi / 4), tilt=(pi / 4, pi / 2),
        roll=(-pi / 18, pi / 18), aov=(pi / 22, pi / 2),
        c_x=(36 - 16.5, 36 + 16.5), c_y=(40.0, 110.0),
        c_z=(-40.0, -5.0)),
    "main_behind": dict(
        pan=(pi / 4, 3 * pi / 4), tilt=(pi / 16, pi / 2),
        roll=(-pi / 32, pi / 32), aov=(pi / 22, pi / 2),
        c_x=(-32.5, -52.5), c_y=(-5.0, 5.0), c_z=(-35.0, -1.0)),
    "main_tribune": dict(
        pan=(-pi / 4, pi / 4), tilt=(pi / 4, pi / 2),
        roll=(-pi / 18, pi / 18), aov=(pi / 22, pi / 2),
        c_x=(-40.0, 40.0), c_y=(40.0, 110.0), c_z=(-40.0, -5.0)),
}


def mean_std_with_confidence_interval(vmin, vmax, sigma_scale,
                                      _steps=1000, round_decimals=4):
    """mean/std of linspace(vmin, vmax), std scaled — exactly the
    reference derivation (utils/data_distr.py: sigma_scale 1.65 -> 90%,
    1.96 -> 95%, 2.58 -> 99% of samples inside [vmin, vmax])."""
    x = np.linspace(vmin, vmax, _steps)
    return (round(float(x.mean()), round_decimals),
            round(float(x.std(ddof=1) * sigma_scale), round_decimals))


def get_cam_distr(sigma_scale: float = 1.96,
                  camera_type: str = "main_center") -> dict:
    """name -> (mean, std) for the 7 camera parameters."""
    if camera_type not in _MINMAX:
        raise ValueError(f"unknown camera type {camera_type!r}; "
                         f"available: {CAMERA_TYPES}")
    return {k: mean_std_with_confidence_interval(*mm, sigma_scale)
            for k, mm in _MINMAX[camera_type].items()}


def get_dist_distr(sigma_scale: float = 2.57) -> dict:
    """Lens distortion (k1, k2) priors (tv_main_center.get_dist_distr)."""
    return {"k1": (0.0, sigma_scale * 0.5),
            "k2": (0.0, sigma_scale * 0.1)}


def priors_array(camera_types=CAMERA_TYPES, sigma_scale: float = 1.96,
                 dist_sigma_scale: float = 2.57,
                 lens_distortion: bool = True) -> np.ndarray:
    """(H, 9, 2) [mean, std] array over hypotheses in PARAM_ORDER.

    With ``lens_distortion=False`` the k1/k2 stds are 0 — the z-scored
    latent then has no effect on those dims (frozen at the prior mean),
    mirroring ``dist_distr is None`` in the reference module
    (tvcalib/module.py:33)."""
    dist = get_dist_distr(dist_sigma_scale)
    out = np.zeros((len(camera_types), len(PARAM_ORDER), 2), np.float32)
    for h, ct in enumerate(camera_types):
        cd = get_cam_distr(sigma_scale, ct)
        for i, name in enumerate(PARAM_ORDER):
            if name in cd:
                out[h, i] = cd[name]
            else:
                m, s = dist[name]
                out[h, i] = (m, s if lens_distortion else 0.0)
    return out
