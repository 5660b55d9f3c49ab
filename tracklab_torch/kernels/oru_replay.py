"""The ORU replay kernel (``csrc/oru_replay.cu``) and its plain version.

A port-only kernel: it replaces no Pallas kernel but the JAX package's
``lax.while_loop`` in ``XYSRFilter.oru_replay_batch``
(``tracklab_tpu/ops/kalman.py:242``), whose loop bound stays on the device.
Eager PyTorch can only loop to a bound read on the host; the kernel runs one
thread per track slot, each replaying its own gap with x and P in
registers, so a tracker step issues no host sync for it. See the source note
in ``csrc/oru_replay.cu``.

:func:`oru_replay` is the wrapper: for CPU tensors it runs
:func:`oru_replay_plain`, for CUDA tensors it launches the kernel (or
raises). Its ``launches`` attribute counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from tracklab_torch.ops.kalman import XYSRFilter, _where

__all__ = ["oru_replay", "oru_replay_plain"]


def oru_replay_plain(x_frozen, P_frozen, z_prev, z_new, gap, need):
    """Observation-centric re-update (kalmanfilter.py:390-432), batched
    over track slots: rewind to the frozen state and replay a linearly
    interpolated virtual trajectory from ``z_prev`` to ``z_new`` (xysr,
    interpolated in x, y, w, h), one virtual update per step below the
    slot's ``gap`` and a predict between them, to the largest gap needed.

    The loop bound is read on the host (one sync per call). Shapes: x (...,
    7), P (..., 7, 7), z (..., 4), gap (...) int, need (...) bool."""
    dtype = x_frozen.dtype
    x1, y1, s1, r1 = z_prev.unbind(-1)
    x2, y2, s2, r2 = z_new.unbind(-1)
    w1 = torch.sqrt(torch.clamp(s1 * r1, min=1e-12))
    h1 = torch.sqrt(torch.clamp(s1 / torch.clamp(r1, min=1e-12), min=1e-12))
    w2 = torch.sqrt(torch.clamp(s2 * r2, min=1e-12))
    h2 = torch.sqrt(torch.clamp(s2 / torch.clamp(r2, min=1e-12), min=1e-12))
    tg = torch.clamp(gap, min=1).to(dtype)
    dx, dy = (x2 - x1) / tg, (y2 - y1) / tg
    dw, dh = (w2 - w1) / tg, (h2 - h1) / tg
    max_steps = int(torch.where(need, gap, 0).max()) if need.numel() else 0
    x, P = x_frozen, P_frozen
    for i in range(max_steps):
        active = need & (i < gap)
        t = float(i + 1)
        vw = w1 + t * dw
        vh = h1 + t * dh
        vz = torch.stack([x1 + t * dx, y1 + t * dy, vw * vh,
                          vw / torch.clamp(vh, min=1e-12)], dim=-1)
        x_u, P_u = XYSRFilter.update(x, P, vz)
        do_pred = active & (i < gap - 1)
        x_p, P_p = XYSRFilter.predict(x_u, P_u)
        x = _where(active, _where(do_pred, x_p, x_u), x)
        P = _where(active, _where(do_pred, P_p, P_u), P)
    return x, P


@functools.cache
def _lib():
    from tracklab_torch.kernels._build import load

    fn = load("oru_replay").tl_oru_replay
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def oru_replay(x_frozen, P_frozen, z_prev, z_new, gap, need):
    """ORU replay over any leading slot dims: x (..., 7), P (..., 7, 7), z
    (..., 4) f32, gap (...) int, need (...) bool. Returns (x, P).

    CPU tensors run :func:`oru_replay_plain`. CUDA tensors launch the
    kernel, which takes f32 and issues no host sync."""
    lead = x_frozen.shape[:-1]
    if (x_frozen.shape[-1:] != (7,) or P_frozen.shape != lead + (7, 7)
            or z_prev.shape != lead + (4,) or z_new.shape != lead + (4,)
            or gap.shape != lead or need.shape != lead):
        raise ValueError("ORU replay wants x (..., 7), P (..., 7, 7), z "
                         "(..., 4), gap and need (...) over one slot shape; "
                         f"got {tuple(x_frozen.shape)}, "
                         f"{tuple(P_frozen.shape)}, {tuple(z_prev.shape)}, "
                         f"{tuple(z_new.shape)}, {tuple(gap.shape)}, "
                         f"{tuple(need.shape)}")
    if not x_frozen.is_cuda:
        return oru_replay_plain(x_frozen, P_frozen, z_prev, z_new, gap, need)
    ts = (x_frozen, P_frozen, z_prev, z_new, gap, need)
    if any(t.device != x_frozen.device for t in ts):
        raise ValueError("ORU replay inputs must share one device")
    if any(t.dtype != torch.float32 for t in ts[:4]) \
            or need.dtype != torch.bool:
        raise TypeError("the ORU replay kernel takes f32 x, P, z and bool "
                        "need")
    x_f, P_f, zp, zn, nd = (t.contiguous() for t in (*ts[:4], need))
    g = gap.to(torch.int32).contiguous()
    x_out = torch.empty_like(x_f)
    P_out = torch.empty_like(P_f)
    stream = torch.cuda.current_stream(x_f.device).cuda_stream
    with torch.cuda.device(x_f.device):
        err = _lib()(x_f.data_ptr(), P_f.data_ptr(), zp.data_ptr(),
                     zn.data_ptr(), g.data_ptr(), nd.data_ptr(),
                     x_out.data_ptr(), P_out.data_ptr(), need.numel(), stream)
    if err != 0:
        raise RuntimeError(f"ORU replay launch failed: cudaError {err}")
    oru_replay.launches += 1
    return x_out, P_out


oru_replay.launches = 0
