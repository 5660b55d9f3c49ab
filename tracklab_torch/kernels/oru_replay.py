"""The ORU replay kernels (``csrc/oru_replay.cu``) and their plain
versions.

Port-only kernels: they replace no Pallas kernel but two of the JAX
package's ``lax.while_loop``s, whose loop bounds stay on the device:
OC-SORT's ``XYSRFilter.oru_replay_batch`` (``tracklab_tpu/ops/kalman.py:242``)
and Deep-OC-SORT's "new KF" replay ``_nkf_oru_replay_batch``
(``tracklab_tpu/trackers/deepocsort.py:117``). Eager PyTorch can only loop
to a bound read on the host; each kernel runs one thread per track slot,
each replaying its own gap with x and P in registers, so a tracker step
issues no host sync for it. See the source note in ``csrc/oru_replay.cu``.

:func:`oru_replay` and :func:`oru_replay_nkf` are the wrappers: for CPU
tensors they run :func:`oru_replay_plain` and :func:`oru_replay_nkf_plain`,
for CUDA tensors they launch their kernel (or raise). Each wrapper's
``launches`` attribute counts its kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from tracklab_torch.ops.kalman import XYSRFilter, _where

__all__ = ["oru_replay", "oru_replay_plain", "oru_replay_nkf",
           "oru_replay_nkf_plain"]


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


def oru_replay_nkf_plain(x_frozen, P_frozen, z_prev, z_new, gap, need):
    """Deep-OC-SORT's ORU replay (the "new KF", deepocsort.py:117-150),
    batched over track slots: rewind to the frozen state and replay the
    xywh measurements interpolated linearly from ``z_prev`` to ``z_new``,
    one virtual update per step below the slot's ``gap`` and a predict
    (velocities not frozen) between them, to the largest gap needed.

    The loop bound is read on the host (one sync per call). Shapes: x (...,
    8), P (..., 8, 8), z (..., 4), gap (...) int, need (...) bool."""
    from tracklab_torch.trackers.deepocsort import _nkf_predict, _nkf_update

    tg = torch.clamp(gap, min=1).to(x_frozen.dtype)[..., None]
    dz = (z_new - z_prev) / tg
    no = torch.zeros_like(need)
    max_steps = int(torch.where(need, gap, 0).max()) if need.numel() else 0
    x, P = x_frozen, P_frozen
    for i in range(max_steps):
        active = need & (i < gap)
        x_u, P_u = _nkf_update(x, P, z_prev + float(i + 1) * dz)
        do_pred = active & (i < gap - 1)
        x_p, P_p = _nkf_predict(x_u, P_u, no)
        x = _where(active, _where(do_pred, x_p, x_u), x)
        P = _where(active, _where(do_pred, P_p, P_u), P)
    return x, P


@functools.cache
def _lib(symbol: str):
    from tracklab_torch.kernels._build import load

    fn = getattr(load("oru_replay"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(symbol, n_state, x_frozen, P_frozen, z_prev, z_new, gap, need):
    """Check the shapes of an ORU replay with an ``n_state``-dim state;
    launch the kernel ``symbol`` on the current stream for CUDA tensors and
    return (x, P), or return None for CPU tensors (the caller runs the
    plain version)."""
    lead = x_frozen.shape[:-1]
    n = n_state
    if (x_frozen.shape[-1:] != (n,) or P_frozen.shape != lead + (n, n)
            or z_prev.shape != lead + (4,) or z_new.shape != lead + (4,)
            or gap.shape != lead or need.shape != lead):
        raise ValueError(f"ORU replay wants x (..., {n}), P (..., {n}, {n}),"
                         " z (..., 4), gap and need (...) over one slot "
                         f"shape; got {tuple(x_frozen.shape)}, "
                         f"{tuple(P_frozen.shape)}, {tuple(z_prev.shape)}, "
                         f"{tuple(z_new.shape)}, {tuple(gap.shape)}, "
                         f"{tuple(need.shape)}")
    if not x_frozen.is_cuda:
        return None
    ts = (x_frozen, P_frozen, z_prev, z_new, gap, need)
    if any(t.device != x_frozen.device for t in ts):
        raise ValueError("ORU replay inputs must share one device")
    if any(t.dtype != torch.float32 for t in ts[:4]) \
            or need.dtype != torch.bool:
        raise TypeError("the ORU replay kernels take f32 x, P, z and bool "
                        "need")
    x_f, P_f, zp, zn, nd = (t.contiguous() for t in (*ts[:4], need))
    g = gap.to(torch.int32).contiguous()
    x_out = torch.empty_like(x_f)
    P_out = torch.empty_like(P_f)
    stream = torch.cuda.current_stream(x_f.device).cuda_stream
    with torch.cuda.device(x_f.device):
        err = _lib(symbol)(x_f.data_ptr(), P_f.data_ptr(), zp.data_ptr(),
                           zn.data_ptr(), g.data_ptr(), nd.data_ptr(),
                           x_out.data_ptr(), P_out.data_ptr(), need.numel(),
                           stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")
    return x_out, P_out


def oru_replay(x_frozen, P_frozen, z_prev, z_new, gap, need):
    """OC-SORT's ORU replay over any leading slot dims: x (..., 7), P (...,
    7, 7), z (..., 4) f32, gap (...) int, need (...) bool. Returns (x, P).

    CPU tensors run :func:`oru_replay_plain`. CUDA tensors launch the
    kernel, which takes f32 and issues no host sync."""
    args = (x_frozen, P_frozen, z_prev, z_new, gap, need)
    out = _launch("tl_oru_replay", 7, *args)
    if out is None:
        return oru_replay_plain(*args)
    oru_replay.launches += 1
    return out


def oru_replay_nkf(x_frozen, P_frozen, z_prev, z_new, gap, need):
    """Deep-OC-SORT's ORU replay over any leading slot dims: x (..., 8), P
    (..., 8, 8), z (..., 4) xywh f32, gap (...) int, need (...) bool.
    Returns (x, P).

    CPU tensors run :func:`oru_replay_nkf_plain`. CUDA tensors launch the
    kernel, which takes f32 and issues no host sync."""
    args = (x_frozen, P_frozen, z_prev, z_new, gap, need)
    out = _launch("tl_oru_replay_nkf", 8, *args)
    if out is None:
        return oru_replay_nkf_plain(*args)
    oru_replay_nkf.launches += 1
    return out


oru_replay.launches = 0
oru_replay_nkf.launches = 0
