"""Global motion estimation on the device: pyramidal Lucas-Kanade over dense
image gradients (counterpart of tracklab_tpu.motion.lk_jax).

A global affine warp between consecutive grayscale frames by Gauss-Newton:
gradients, bilinear warps, two large reductions and a 6x6 solve per step,
all batched over any leading axes of frame pairs, so one call estimates a
whole chunk's warps (the JAX package maps the single-pair estimator with
``jax.vmap``). The fixed pyramid and iteration counts are Python loops; the
6x6 solve is ``torch.linalg.solve_ex`` without its error check and the
final 3x3 inverse is closed-form, so nothing reads a value on the host. The
reductions are batched products: keep TF32 off (PyTorch's default) on the
card, or they lose the f32 precision the estimate is held to.
"""
from __future__ import annotations

import torch

__all__ = ["estimate_affine_lk", "warp_affine", "gmc_warps"]


def _grayscale(img):
    """(..., H, W, 3) RGB -> (..., H, W); (..., H, W) passes through. A
    last axis of size 3 on an input of three or more dims is read as RGB."""
    if img.dim() >= 3 and img.shape[-1] == 3:
        return (0.299 * img[..., 0] + 0.587 * img[..., 1]
                + 0.114 * img[..., 2])
    return img


def _grid(H, W, device):
    """Pixel coordinates (ys, xs), each (H, W) f32."""
    ys = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    return ys.expand(H, W), xs.expand(H, W)


def warp_affine(img, warp):
    """Sample ``img`` (..., H, W) at affinely warped coordinates (bilinear,
    zero pad): ``warp`` (..., 2, 3) maps output coords to input coords.
    Returns the samples and the inside mask (f32), each (..., H, W)."""
    H, W = img.shape[-2:]
    ys, xs = _grid(H, W, img.device)

    def c(i, j):
        return warp[..., i, j, None, None]

    sx = c(0, 0) * xs + c(0, 1) * ys + c(0, 2)
    sy = c(1, 0) * xs + c(1, 1) * ys + c(1, 2)
    x0 = torch.clamp(torch.floor(sx), 0, W - 2)
    y0 = torch.clamp(torch.floor(sy), 0, H - 2)
    wx = torch.clamp(sx - x0, 0.0, 1.0)
    wy = torch.clamp(sy - y0, 0.0, 1.0)
    idx = (y0.long() * W + x0.long()).flatten(-2)
    flat = img.flatten(-2).expand(idx.shape)

    def tap(off):
        return flat.gather(-1, idx + off).reshape(sx.shape)

    out = (tap(0) * (1 - wx) * (1 - wy) + tap(1) * wx * (1 - wy)
           + tap(W) * (1 - wx) * wy + tap(W + 1) * wx * wy)
    inside = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
    return out, inside.to(torch.float32)


def _params_to_warp(p):
    """[a11 - 1, a12, tx, a21, a22 - 1, ty] (..., 6) -> (..., 2, 3)."""
    return torch.stack([1 + p[..., 0], p[..., 1], p[..., 2],
                        p[..., 3], 1 + p[..., 4], p[..., 5]],
                       dim=-1).reshape(p.shape[:-1] + (2, 3))


def _lk_level(prev, cur, p, iters):
    """``iters`` Gauss-Newton refinements of the affine parameters p (...,
    6) at one pyramid level, so that warp(prev, p) ~= cur (the forward
    additive approximation of the JAX estimator)."""
    H, W = prev.shape[-2:]
    gy, gx = torch.gradient(cur, dim=(-2, -1))
    ys, xs = _grid(H, W, prev.device)
    jac = torch.stack([gx * xs, gx * ys, gx, gy * xs, gy * ys, gy], dim=-3)
    damp = 1e-3 * torch.eye(6, dtype=torch.float32, device=prev.device)
    for _ in range(iters):
        sampled, mask = warp_affine(prev, _params_to_warp(p))
        err = (cur - sampled) * mask
        jm = jac * mask[..., None, :, :]
        A = torch.einsum("...ihw,...jhw->...ij", jm, jm)
        b = torch.einsum("...ihw,...hw->...i", jm, err)
        p = p + torch.linalg.solve_ex(A + damp, b[..., None])[0][..., 0]
    return p


def _downscale2(img):
    """2x2 box mean over the last two axes (odd edges dropped)."""
    H, W = img.shape[-2:]
    H2, W2 = H // 2, W // 2
    x = img[..., :2 * H2, :2 * W2].reshape(img.shape[:-2] + (H2, 2, W2, 2))
    return x.mean(dim=(-3, -1))


def estimate_affine_lk(prev_img, cur_img, levels: int = 3, iters: int = 10):
    """The 2x3 affine warp mapping prev-frame coords to cur-frame coords.

    ``prev_img``/``cur_img``: (..., H, W) grayscale or (..., H, W, 3) RGB,
    uint8 or float, with the same leading axes (a batch of frame pairs).
    Returns (..., 2, 3) f32 on the inputs' device."""
    prev = _grayscale(prev_img.to(torch.float32))
    cur = _grayscale(cur_img.to(torch.float32))
    pyr = [(prev, cur)]
    for _ in range(levels - 1):
        prev, cur = _downscale2(prev), _downscale2(cur)
        pyr.append((prev, cur))
    p = torch.zeros(prev.shape[:-2] + (6,), dtype=torch.float32,
                    device=prev.device)
    for i, (lp, lc) in enumerate(reversed(pyr)):
        p = _lk_level(lp, lc, p, iters)
        if i < levels - 1:
            # translations double at the next finer level
            p = torch.cat([p[..., :2], p[..., 2:3] * 2.0, p[..., 3:5],
                           p[..., 5:6] * 2.0], dim=-1)
    # the estimate maps cur coords to prev sample locations; invert the
    # affine map [[A, t], [0, 1]] in closed form for prev -> cur
    a, b, tx = 1 + p[..., 0], p[..., 1], p[..., 2]
    c, d, ty = p[..., 3], 1 + p[..., 4], p[..., 5]
    det = a * d - b * c
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    return torch.stack([ia, ib, -(ia * tx + ib * ty),
                        ic, id_, -(ic * tx + id_ * ty)],
                       dim=-1).reshape(p.shape[:-1] + (2, 3))


def gmc_warps(frames, levels: int = 3, iters: int = 10, prev=None):
    """Camera warps of a stack of frames (F, H, W[, 3]) -> (F, 2, 3) f32:
    ``warp[t]`` maps frame t - 1 coords to frame t coords, every pair
    estimated in one batched call. ``warp[0]`` is the identity, or, when
    ``prev`` (H, W[, 3]) is the frame before ``frames[0]`` (a video
    continued from an earlier chunk), the warp from it to ``frames[0]``.
    The one-device form of the JAX package's ``gmc_warps_time_sharded``."""
    if prev is not None:
        return estimate_affine_lk(torch.cat([prev[None], frames[:-1]]),
                                  frames, levels, iters)
    eye = torch.eye(2, 3, dtype=torch.float32, device=frames.device)[None]
    if frames.shape[0] < 2:
        return eye.expand(frames.shape[0], 2, 3).clone()
    return torch.cat([eye, estimate_affine_lk(frames[:-1], frames[1:],
                                              levels, iters)])
