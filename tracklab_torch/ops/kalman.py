"""Kalman filters in PyTorch (counterpart of tracklab_tpu.ops.kalman):
OC-SORT's ``XYSRFilter``, the DeepSORT/ByteTrack ``XYAHFilter``,
StrongSORT's ``XYAHNSAFilter``, BPBReID-StrongSORT's ``XYAHNSAHFilter`` and
BoT-SORT's ``XYWHFilter``, with their Mahalanobis gating.

Functions take any number of leading batch dimensions (track slots, and
videos before them): ``x (..., n)``, ``P (..., n, n)``, ``z (..., 4)``, so
each one is also the JAX package's ``*_batch`` form. The other filters come
with their trackers.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["XYSRFilter", "XYAHFilter", "XYAHNSAFilter", "XYAHNSAHFilter",
           "XYWHFilter", "CHI2INV95_4D", "CHI2INV95_2D"]

# 0.95 quantiles of the chi-square distribution with 4 and 2 degrees of
# freedom (the DeepSORT gating thresholds)
CHI2INV95_4D = 9.4877
CHI2INV95_2D = 5.9915


def _inv4(m):
    """Closed-form 4x4 inverse (adjugate / det) over leading batch dims."""
    # the 16 entries as views, indexed once (the formula reads each ~6x)
    a = [[m[..., i, j] for j in range(4)] for i in range(4)]
    s0 = a[0][0] * a[1][1] - a[1][0] * a[0][1]
    s1 = a[0][0] * a[1][2] - a[1][0] * a[0][2]
    s2 = a[0][0] * a[1][3] - a[1][0] * a[0][3]
    s3 = a[0][1] * a[1][2] - a[1][1] * a[0][2]
    s4 = a[0][1] * a[1][3] - a[1][1] * a[0][3]
    s5 = a[0][2] * a[1][3] - a[1][2] * a[0][3]
    c5 = a[2][2] * a[3][3] - a[3][2] * a[2][3]
    c4 = a[2][1] * a[3][3] - a[3][1] * a[2][3]
    c3 = a[2][1] * a[3][2] - a[3][1] * a[2][2]
    c2 = a[2][0] * a[3][3] - a[3][0] * a[2][3]
    c1 = a[2][0] * a[3][2] - a[3][0] * a[2][2]
    c0 = a[2][0] * a[3][1] - a[3][0] * a[2][1]
    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    inv_det = 1.0 / det
    b = [
        [a[1][1] * c5 - a[1][2] * c4 + a[1][3] * c3,
         -a[0][1] * c5 + a[0][2] * c4 - a[0][3] * c3,
         a[3][1] * s5 - a[3][2] * s4 + a[3][3] * s3,
         -a[2][1] * s5 + a[2][2] * s4 - a[2][3] * s3],
        [-a[1][0] * c5 + a[1][2] * c2 - a[1][3] * c1,
         a[0][0] * c5 - a[0][2] * c2 + a[0][3] * c1,
         -a[3][0] * s5 + a[3][2] * s2 - a[3][3] * s1,
         a[2][0] * s5 - a[2][2] * s2 + a[2][3] * s1],
        [a[1][0] * c4 - a[1][1] * c2 + a[1][3] * c0,
         -a[0][0] * c4 + a[0][1] * c2 - a[0][3] * c0,
         a[3][0] * s4 - a[3][1] * s2 + a[3][3] * s0,
         -a[2][0] * s4 + a[2][1] * s2 - a[2][3] * s0],
        [-a[1][0] * c3 + a[1][1] * c1 - a[1][2] * c0,
         a[0][0] * c3 - a[0][1] * c1 + a[0][2] * c0,
         -a[3][0] * s3 + a[3][1] * s1 - a[3][2] * s0,
         a[2][0] * s3 - a[2][1] * s1 + a[2][2] * s0],
    ]
    rows = [torch.stack(rw, dim=-1) for rw in b]
    return torch.stack(rows, dim=-2) * inv_det[..., None, None]


def _inv2(m):
    """Closed-form 2x2 inverse over leading batch dims."""
    det = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    adj = torch.stack([torch.stack([m[..., 1, 1], -m[..., 0, 1]], dim=-1),
                       torch.stack([-m[..., 1, 0], m[..., 0, 0]], dim=-1)],
                      dim=-2)
    return adj / det[..., None, None]


def _mahalanobis(pm, pc, zs):
    """Squared Mahalanobis distances of measurements ``zs`` (..., N, k) from
    Gaussians ``pm`` (..., k), ``pc`` (..., k, k) through the closed-form
    2x2/4x4 inverses; returns (..., N)."""
    inv = _inv4(pc) if pc.shape[-1] == 4 else _inv2(pc)
    d = zs - pm[..., None, :]
    return ((d @ inv) * d).sum(dim=-1)


def _where(cond, a, b):
    """``torch.where`` with ``cond`` broadcast over trailing dims of a."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim()
                                                         - cond.dim())), a, b)


@functools.lru_cache(maxsize=None)
def _constants(dtype, device):
    F = torch.eye(7, dtype=dtype)
    F[0, 4] = F[1, 5] = F[2, 6] = 1.0
    H = torch.eye(4, 7, dtype=dtype)
    # ocsort.py:80-84: R[2:,2:]*=10; P[4:,4:]*=1000; P*=10;
    # Q[-1,-1]*=0.01; Q[4:,4:]*=0.01
    R = torch.diag(torch.tensor([1.0, 1.0, 10.0, 10.0], dtype=dtype))
    P0 = torch.diag(torch.tensor([10.0, 10.0, 10.0, 10.0, 1e4, 1e4, 1e4],
                                 dtype=dtype))
    Q = torch.diag(torch.tensor([1.0, 1.0, 1.0, 1.0, 0.01, 0.01, 1e-4],
                                dtype=dtype))
    return tuple(m.to(device) for m in (F, H, R, P0, Q))


class XYSRFilter:
    """OC-SORT 7-dim filter. State: [x, y, s, r, vx, vy, vs]."""

    @staticmethod
    def constants(dtype=torch.float32, device=None):
        """(F, H, R, P0, Q), built once per dtype and device: a tensor made
        from Python numbers on the card is a host-to-device copy, which
        waits for the stream, so per-frame code must not rebuild them.
        Callers must not modify them in place."""
        return _constants(dtype, torch.device(device or "cpu"))

    @staticmethod
    def predict(x, P):
        """Predict with the OC-SORT negative-area guard (ocsort.py:154-157:
        if x[6] + x[2] <= 0 then vs := 0). F = I + E, so F x and F P F' are
        slice-adds, in the JAX package's order."""
        _, _, _, _, Q = XYSRFilter.constants(x.dtype, x.device)
        vs = torch.where(x[..., 6] + x[..., 2] <= 0, 0.0, x[..., 6])
        x = torch.cat([x[..., :6], vs[..., None]], dim=-1)
        x = torch.cat([x[..., :3] + x[..., 4:7], x[..., 3:]], dim=-1)
        Pn = P.clone()
        Pn[..., :3, :] += P[..., 4:7, :]
        M = P[..., :, 4:7].clone()
        M[..., :3, :] += P[..., 4:7, 4:7]
        Pn[..., :, :3] += M
        return x, Pn + Q

    @staticmethod
    def update(x, P, z):
        """Joseph-form update specialized for H = [I4 | 0] and diagonal R,
        with S = P[:4, :4] + R inverted in closed form."""
        _, _, R, _, _ = XYSRFilter.constants(x.dtype, x.device)
        r = torch.diagonal(R)
        y = z - x[..., :4]
        PHT = P[..., :, :4]                                   # (..., 7, 4)
        S = P[..., :4, :4] + R
        K = PHT @ _inv4(S)                                    # (..., 7, 4)
        x_new = x + (K @ y[..., None])[..., 0]
        A = P - K @ P[..., :4, :]
        Kt = K.transpose(-1, -2)
        P_new = A - A[..., :, :4] @ Kt + (K * r) @ Kt
        return x_new, P_new

    @staticmethod
    def oru_replay_batch(x_frozen, P_frozen, z_prev, z_new, gap, need):
        """Observation-centric re-update (kalmanfilter.py:390-432), batched
        over track slots: rewind to the frozen state and replay a linearly
        interpolated virtual trajectory from ``z_prev`` to ``z_new`` (xysr,
        interpolated in x, y, w, h), each slot to its own gap.

        CUDA tensors launch the ORU replay kernel (``kernels/oru_replay.py``),
        one thread per slot, with no host sync; CPU tensors run its plain
        version, the masked loop to the largest gap. Shapes: x (..., T, 7),
        P (..., T, 7, 7), z (..., T, 4), gap (..., T) int, need (..., T)
        bool.
        """
        from tracklab_torch.kernels.oru_replay import oru_replay

        return oru_replay(x_frozen, P_frozen, z_prev, z_new, gap, need)

    @staticmethod
    def to_ltrb(x):
        """State -> ltrb box (ocsort.py:36-46 convert_x_to_bbox)."""
        w = torch.sqrt(x[..., 2] * x[..., 3])
        h = x[..., 2] / w
        return torch.stack([x[..., 0] - w / 2.0, x[..., 1] - h / 2.0,
                            x[..., 0] + w / 2.0, x[..., 1] + h / 2.0], dim=-1)



def _diag(std):
    """diag(std**2) over leading dims: (..., n) -> (..., n, n)."""
    return torch.diag_embed(std * std)


def _shift4_predict(x, P, Q):
    """x' = F x, P' = F P F' + Q for the 8-dim constant-velocity F = I + E
    (E[i, i+4] = 1, i < 4), as slice-adds in the JAX package's order."""
    x = torch.cat([x[..., :4] + x[..., 4:], x[..., 4:]], dim=-1)
    Pn = P.clone()
    Pn[..., :4, :] += P[..., 4:, :]
    M = P[..., :, 4:].clone()
    M[..., :4, :] += P[..., 4:, 4:]
    Pn[..., :, :4] += M
    return x, Pn + Q


def _proj4_update(x, P, z, pc):
    """Kalman update for H = [I4 | 0] given the projected innovation
    covariance pc = P[:4, :4] + R: K = P[:, :4] pc^-1, P' = P - K pc K'."""
    K = P[..., :, :4] @ _inv4(pc)
    x_new = x + (K @ (z - x[..., :4])[..., None])[..., 0]
    P_new = P - K @ pc @ K.transpose(-1, -2)
    return x_new, P_new


class XYAHFilter:
    """DeepSORT/ByteTrack 8-dim filter. State: [x, y, a, h, vx, vy, va, vh].
    Noise stds scale with the box height h (byte_track/kalman_filter.py)."""

    WP = 1.0 / 20
    WV = 1.0 / 160

    @staticmethod
    def initiate(z):
        """Measurement (..., 4) xyah -> mean (..., 8), covariance."""
        h = z[..., 3]
        one = torch.ones_like(h)
        x = torch.cat([z, torch.zeros_like(z)], dim=-1)
        std = torch.stack([
            2 * XYAHFilter.WP * h, 2 * XYAHFilter.WP * h, 1e-2 * one,
            2 * XYAHFilter.WP * h,
            10 * XYAHFilter.WV * h, 10 * XYAHFilter.WV * h, 1e-5 * one,
            10 * XYAHFilter.WV * h], dim=-1)
        return x, _diag(std)

    @staticmethod
    def _motion_cov(x):
        h = x[..., 3]
        one = torch.ones_like(h)
        std = torch.stack([
            XYAHFilter.WP * h, XYAHFilter.WP * h, 1e-2 * one,
            XYAHFilter.WP * h,
            XYAHFilter.WV * h, XYAHFilter.WV * h, 1e-5 * one,
            XYAHFilter.WV * h], dim=-1)
        return _diag(std)

    @staticmethod
    def predict(x, P):
        return _shift4_predict(x, P, XYAHFilter._motion_cov(x))

    @staticmethod
    def _innovation_cov(x):
        h = x[..., 3]
        std = torch.stack([XYAHFilter.WP * h, XYAHFilter.WP * h,
                           1e-1 * torch.ones_like(h), XYAHFilter.WP * h],
                          dim=-1)
        return _diag(std)

    @staticmethod
    def update(x, P, z):
        pc = P[..., :4, :4] + XYAHFilter._innovation_cov(x)
        return _proj4_update(x, P, z, pc)


def _xyah_mats(dtype=torch.float32, device=None):
    """The 8-dim constant-velocity transition F = I + E (E[i, i+4] = 1) and
    the projection H = [I4 | 0]."""
    F = torch.eye(8, dtype=dtype, device=device)
    F[:4, 4:] += torch.eye(4, dtype=dtype, device=device)
    return F, torch.eye(4, 8, dtype=dtype, device=device)


class XYAHNSAFilter:
    """StrongSORT's NSA Kalman filter on [x, y, a, h, v*]: per-component
    noise scaling (position stds from x, y and h, the aspect ratio's from a)
    and measurement noise that shrinks with the detection confidence
    (strong_sort/sort/kalman_filter.py:48-174)."""

    WP = 1.0 / 20
    WV = 1.0 / 160

    @staticmethod
    def _std8(m, kp, ka, kv, kva):
        """Stds (..., 8) from a mean or measurement m (..., >= 4): position
        kp * (x, y, -, h), aspect ka * a, velocities kv * (x, y, -, h) and
        kva * a."""
        x, y, a, h = m[..., 0], m[..., 1], m[..., 2], m[..., 3]
        return torch.stack([kp * x, kp * y, ka * a, kp * h,
                            kv * x, kv * y, kva * a, kv * h], dim=-1)

    @staticmethod
    def initiate(z):
        """Measurement (..., 4) xyah -> mean (..., 8), covariance."""
        x = torch.cat([z, torch.zeros_like(z)], dim=-1)
        f = XYAHNSAFilter
        return x, _diag(f._std8(z, 2 * f.WP, 1.0, 10 * f.WV, 0.1))

    @staticmethod
    def predict(x, P):
        f = XYAHNSAFilter
        return _shift4_predict(x, P, _diag(f._std8(x, f.WP, 1.0, f.WV, 0.1)))

    @staticmethod
    def project(x, P, confidence=0.0):
        """(H x, H P H' + R) with R's stds (wp h, wp h, 0.1, wp h) scaled by
        (1 - confidence)."""
        p = XYAHNSAFilter.WP * x[..., 3]
        std = torch.stack([p, p, torch.full_like(p, 1e-1), p],
                          dim=-1) * (1.0 - confidence)
        return x[..., :4], P[..., :4, :4] + _diag(std)

    @staticmethod
    def update(x, P, z, confidence=0.0):
        """``confidence`` is a number or a tensor over the leading dims."""
        if isinstance(confidence, torch.Tensor):
            confidence = confidence[..., None]
        _, pc = XYAHNSAFilter.project(x, P, confidence)
        return _proj4_update(x, P, z, pc)

    @staticmethod
    def gating_distance(x, P, zs, only_position=False):
        """Squared Mahalanobis distance of each measurement ``zs`` (..., D,
        4) from each track ``x`` (..., T, 8): returns (..., T, D)."""
        pm, pc = XYAHNSAFilter.project(x, P)
        if only_position:
            pm, pc, zs = pm[..., :2], pc[..., :2, :2], zs[..., :2]
        return _mahalanobis(pm, pc, zs[..., None, :, :])


class XYAHNSAHFilter:
    """BPBReID-StrongSORT NSA Kalman filter on [x, y, a, h, v*]: every noise
    std, the aspect ratio's included, scales with the box height h, and the
    measurement noise shrinks with the detection confidence (NSA)."""

    WP = 1.0 / 20
    WV = 1.0 / 160

    @staticmethod
    def _std8(h, wp, wv):
        p, v = wp * h, wv * h
        return torch.stack([p, p, p, p, v, v, v, v], dim=-1)

    @staticmethod
    def initiate(z):
        """Measurement (..., 4) xyah -> mean (..., 8), covariance."""
        x = torch.cat([z, torch.zeros_like(z)], dim=-1)
        std = XYAHNSAHFilter._std8(z[..., 3], 2 * XYAHNSAHFilter.WP,
                                   10 * XYAHNSAHFilter.WV)
        return x, _diag(std)

    @staticmethod
    def predict(x, P):
        Q = _diag(XYAHNSAHFilter._std8(x[..., 3], XYAHNSAHFilter.WP,
                                       XYAHNSAHFilter.WV))
        return _shift4_predict(x, P, Q)

    @staticmethod
    def project(x, P, confidence=0.0):
        """(H x, H P H' + R) with R's stds scaled by (1 - confidence)."""
        p = XYAHNSAHFilter.WP * x[..., 3]
        std = torch.stack([p, p, p, p], dim=-1) * (1.0 - confidence)
        return x[..., :4], P[..., :4, :4] + _diag(std)

    @staticmethod
    def update(x, P, z, confidence=0.0):
        """``confidence`` is a number or a tensor over the leading dims."""
        if isinstance(confidence, torch.Tensor):
            confidence = confidence[..., None]
        _, pc = XYAHNSAHFilter.project(x, P, confidence)
        return _proj4_update(x, P, z, pc)

    @staticmethod
    def gating_distance(x, P, zs, only_position=False):
        """Squared Mahalanobis distance of each measurement ``zs`` (..., D,
        4) from each track ``x`` (..., T, 8): returns (..., T, D)."""
        pm, pc = XYAHNSAHFilter.project(x, P)
        if only_position:
            pm, pc, zs = pm[..., :2], pc[..., :2, :2], zs[..., :2]
        return _mahalanobis(pm, pc, zs[..., None, :, :])


class XYWHFilter:
    """BoT-SORT's 8-dim filter on [x, y, w, h, v*]: the noise stds scale
    with w and h per component pair (bot_sort/kalman_filter.py:55-175)."""

    WP = 1.0 / 20
    WV = 1.0 / 160

    @staticmethod
    def _std8(m, kp, kv):
        """Stds (..., 8): kp * (w, h, w, h), then kv * (w, h, w, h)."""
        w, h = m[..., 2], m[..., 3]
        return torch.stack([kp * w, kp * h, kp * w, kp * h,
                            kv * w, kv * h, kv * w, kv * h], dim=-1)

    @staticmethod
    def initiate(z):
        """Measurement (..., 4) xywh -> mean (..., 8), covariance."""
        f = XYWHFilter
        x = torch.cat([z, torch.zeros_like(z)], dim=-1)
        return x, _diag(f._std8(z, 2 * f.WP, 10 * f.WV))

    @staticmethod
    def predict(x, P):
        f = XYWHFilter
        return _shift4_predict(x, P, _diag(f._std8(x, f.WP, f.WV)))

    @staticmethod
    def project(x, P):
        """(H x, H P H' + R) with R's stds wp * (w, h, w, h)."""
        std = XYWHFilter._std8(x, XYWHFilter.WP, XYWHFilter.WV)[..., :4]
        return x[..., :4], P[..., :4, :4] + _diag(std)

    @staticmethod
    def update(x, P, z):
        _, pc = XYWHFilter.project(x, P)
        return _proj4_update(x, P, z, pc)

    @staticmethod
    def gating_distance(x, P, zs, only_position=False):
        """Squared Mahalanobis distance of each measurement ``zs`` (..., D,
        4) from each track ``x`` (..., T, 8): returns (..., T, D)."""
        pm, pc = XYWHFilter.project(x, P)
        if only_position:
            pm, pc, zs = pm[..., :2], pc[..., :2, :2], zs[..., :2]
        return _mahalanobis(pm, pc, zs[..., None, :, :])
