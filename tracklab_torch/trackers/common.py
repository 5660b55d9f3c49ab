"""Shared tracker plumbing: padded detection batches and slot allocation
(counterpart of tracklab_tpu.trackers.common).

Trackers keep fixed-capacity slot tensors plus active masks; births claim
free slots in detection order (the reference's id-assignment order) and
deaths clear the mask. Every function here is free of host syncs.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tracklab_torch.device import resolve_device

__all__ = ["Detections", "pad_detections", "cumsum_rank", "claim_slots",
           "birth_scatter", "reset_wrapped_step", "stack_frames",
           "concat_resets"]


class Detections(NamedTuple):
    """One frame of detections, padded to a fixed capacity D (or a stack
    of frames with a leading axis).

    ltrb:  (D, 4) float boxes
    conf:  (D,) float scores
    cls:   (D,) float category ids
    ref:   (D,) int32 caller-side row ids
    valid: (D,) bool
    """
    ltrb: torch.Tensor
    conf: torch.Tensor
    cls: torch.Tensor
    ref: torch.Tensor
    valid: torch.Tensor


def pad_detections(ltrb, conf, cls=None, ref=None, capacity=64,
                   dtype=torch.float32, device=None) -> Detections:
    """Host helper: ragged numpy detections -> fixed-capacity tensors on
    ``device`` (``cuda`` unless told otherwise)."""
    dev = resolve_device(device)
    np_dt = torch.empty((), dtype=dtype).numpy().dtype
    n = min(len(ltrb), capacity)
    out_ltrb = np.zeros((capacity, 4), np_dt)
    out_conf = np.zeros((capacity,), np_dt)
    out_cls = np.zeros((capacity,), np_dt)
    out_ref = np.full((capacity,), -1, np.int32)
    valid = np.zeros((capacity,), bool)
    out_ltrb[:n] = np.asarray(ltrb, np_dt)[:n]
    out_conf[:n] = np.asarray(conf, np_dt)[:n]
    if cls is not None:
        out_cls[:n] = np.asarray(cls, np_dt)[:n]
    out_ref[:n] = (np.asarray(ref, np.int32)[:n] if ref is not None
                   else np.arange(n, dtype=np.int32))
    valid[:n] = True
    return Detections(*(torch.from_numpy(a).to(dev) for a in
                        (out_ltrb, out_conf, out_cls, out_ref, valid)))


def cumsum_rank(mask):
    """Rank of each True element among True elements (0-based), int32."""
    return torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1


def claim_slots(free_slots, want):
    """Assign free track slots to birth candidates in detection order.

    free_slots: (T,) bool; want: (D,) bool. Returns det2slot (D,) int32,
    -1 where out of capacity.
    """
    T = free_slots.shape[0]
    dev = free_slots.device
    slot_rank = cumsum_rank(free_slots)
    nth_free = torch.full((T + 1,), -1, dtype=torch.int32, device=dev)
    tgt = torch.where(free_slots, slot_rank, T).long()
    nth_free.scatter_(0, tgt, torch.arange(T, dtype=torch.int32, device=dev))
    n_free = free_slots.sum(dtype=torch.int32)
    want_rank = cumsum_rank(want)
    ok = want & (want_rank < n_free)
    return torch.where(ok, nth_free[torch.clamp(want_rank, 0, T).long()], -1)


def birth_scatter(det2slot, birth, arr, val):
    """Write ``val[d]`` into ``arr[det2slot[d]]`` for each birth det, as a
    one-hot masked sum. Slots are claimed at most once, so the one-hot rows
    are disjoint and the sum is exact for every dtype (bool via any)."""
    T = arr.shape[0]
    sel = ((det2slot[:, None]
            == torch.arange(T, dtype=torch.int32, device=arr.device)[None, :])
           & birth[:, None])                                   # (D, T)
    claimed = sel.any(dim=0)
    sel_e = sel.reshape(sel.shape + (1,) * (arr.dim() - 1))
    val_e = val[:, None]
    if arr.dtype == torch.bool:
        picked = (sel_e & val_e).any(dim=0)
    else:
        picked = torch.where(sel_e, val_e.to(arr.dtype),
                             torch.zeros((), dtype=arr.dtype,
                                         device=arr.device)).sum(dim=0)
    cl = claimed.reshape(claimed.shape + (1,) * (arr.dim() - 1))
    return torch.where(cl, picked.to(arr.dtype), arr)


def reset_wrapped_step(step_fn, init_state):
    """Wrap a tracker step with a per-frame state reset: the returned step
    takes ``(x, reset)`` and re-initializes the carry where ``reset`` (a
    bool scalar tensor) is True, selected on the device."""

    def step(carry, inp):
        x, reset = inp
        carry = type(carry)(*(
            torch.where(reset.reshape((1,) * c.dim()), i, c)
            for i, c in zip(init_state, carry)))
        return step_fn(carry, x)

    return step


def stack_frames(items):
    """Stack a list of per-frame NamedTuples along a new leading axis."""
    return type(items[0])(*(torch.stack(f) for f in zip(*items)))


def concat_resets(n_videos: int, n_frames: int, device=None):
    """(V*F,) bool mask marking each video's first frame in a
    time-concatenated stream."""
    r = torch.zeros((n_videos, n_frames), dtype=torch.bool,
                    device=resolve_device(device))
    r[:, 0] = True
    return r.reshape(-1)
