"""Shared tracker plumbing: padded detection batches and slot allocation
(counterpart of tracklab_tpu.trackers.common).

Trackers keep fixed-capacity slot tensors plus active masks; births claim
free slots in detection order (the reference's id-assignment order) and
deaths clear the mask. Tracker steps are written for a leading video axis
(state fields (V, T, ...), detections (V, D, ...)); ``single_video`` runs
them on one video and ``scan_videos`` over V videos' frames. Every
function here is free of host syncs.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tracklab_torch.device import resolve_device

__all__ = ["Detections", "pad_detections", "cumsum_rank", "claim_slots",
           "birth_scatter", "reset_wrapped_step", "take_rows",
           "invert_match", "repeat_state", "single_video", "scan_frames",
           "scan_videos", "stack_frames", "concat_resets"]


class Detections(NamedTuple):
    """One frame of detections, padded to a fixed capacity D (or a stack
    with leading frame and/or video axes).

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
    """Rank of each True element among True elements along the last axis
    (0-based), int32."""
    return torch.cumsum(mask.to(torch.int32), -1, dtype=torch.int32) - 1


def claim_slots(free_slots, want):
    """Assign free track slots to birth candidates in detection order.

    free_slots: (..., T) bool; want: (..., D) bool, with the same leading
    (video) axes. Returns det2slot (..., D) int32, -1 where out of
    capacity.
    """
    T = free_slots.shape[-1]
    dev = free_slots.device
    lead = free_slots.shape[:-1]
    slot_rank = cumsum_rank(free_slots)
    nth_free = torch.full(lead + (T + 1,), -1, dtype=torch.int32, device=dev)
    tgt = torch.where(free_slots, slot_rank, T).long()
    nth_free.scatter_(-1, tgt, torch.arange(T, dtype=torch.int32,
                                            device=dev).expand(lead + (T,)))
    n_free = free_slots.sum(dim=-1, keepdim=True, dtype=torch.int32)
    want_rank = cumsum_rank(want)
    ok = want & (want_rank < n_free)
    picked = nth_free.gather(-1, torch.clamp(want_rank, 0, T).long())
    return torch.where(ok, picked, -1)


def birth_scatter(det2slot, birth, arr, val):
    """Write ``val[..., d]`` into ``arr[..., det2slot[..., d]]`` for each
    birth det. ``det2slot``/``birth`` (..., D), ``arr`` (..., T, *rest),
    ``val`` (..., D, *rest) with the same leading (video) axes. Slots are
    claimed at most once, so one scatter is exact for every dtype; the
    other dets write into a spare slot that is dropped."""
    n_lead = det2slot.dim() - 1
    T = arr.shape[n_lead]
    rest = arr.shape[n_lead + 1:]
    idx = torch.where(birth, det2slot, T).long()
    idx = idx.reshape(idx.shape + (1,) * len(rest)).expand(
        idx.shape + rest)
    ext = torch.cat([arr, arr.narrow(n_lead, 0, 1)], dim=n_lead)
    ext.scatter_(n_lead, idx, val.to(arr.dtype).expand(idx.shape))
    return ext.narrow(n_lead, 0, T)


def reset_wrapped_step(step_fn, init_state):
    """Wrap a tracker step with a per-frame state reset: the returned step
    takes ``(x, reset)`` and re-initializes the carry where ``reset`` (a
    bool scalar tensor, or one per video for a state with a leading video
    axis) is True, selected on the device."""

    def step(carry, inp):
        x, reset = inp
        carry = type(carry)(*(
            torch.where(reset.reshape(reset.shape + (1,) * (c.dim()
                                                            - reset.dim())),
                        i, c)
            for i, c in zip(init_state, carry)))
        return step_fn(carry, x)

    return step


def take_rows(x, idx):
    """Per video, the detection rows ``idx`` (V, T) of ``x`` (V, D, ...):
    ``x[v, idx[v, t]]``, shape (V, T, ...)."""
    idx = idx.long().reshape(idx.shape + (1,) * (x.dim() - 2))
    return x.gather(1, idx.expand(idx.shape[:2] + x.shape[2:]))


def invert_match(det2trk, n_tracks: int):
    """det->trk map (V, D) to trk->det map (V, T), -1 where no det holds
    the track; matched tracks are unique, so the first holder is the one."""
    sel = det2trk[:, :, None] == torch.arange(n_tracks, dtype=torch.int32,
                                              device=det2trk.device)
    first = torch.argmax(sel.to(torch.int32), dim=1).to(torch.int32)
    return torch.where(sel.any(dim=1), first, -1)


def repeat_state(state, n_videos: int):
    """A tracker state for one video repeated along a new leading video
    axis (each field its own copy)."""
    return type(state)(*(x.expand((n_videos,) + x.shape).clone()
                         for x in state))


def _map_tensors(fn, x):
    """Apply ``fn`` to every tensor of a (nested) tuple or NamedTuple;
    None stays None."""
    if x is None:
        return None
    if isinstance(x, tuple):
        items = [_map_tensors(fn, i) for i in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return fn(x)


def single_video(step_fn, cfg, state, det):
    """Run ``step_fn(cfg, state, det)``, written for a leading video axis,
    on one video's state and inputs (Detections, or a tuple of inputs): the
    axis is added and dropped."""
    st, out = step_fn(cfg, _map_tensors(lambda x: x[None], state),
                      _map_tensors(lambda x: x[None], det))
    return (_map_tensors(lambda x: x[0], st),
            _map_tensors(lambda x: x[0], out))


def scan_frames(step_fn, init, dets, resets=None):
    """Step one video over its frames: ``dets`` fields have a leading frame
    axis. Returns the final state and the outputs with a leading frame
    axis. ``resets`` (F,) bool re-initializes the carry at marked frames."""
    step = step_fn if resets is None else reset_wrapped_step(step_fn, init)
    st, outs = init, []
    for f in range(dets.ltrb.shape[0]):
        d = Detections(*(x[f] for x in dets))
        st, out = step(st, d if resets is None else (d, resets[f]))
        outs.append(out)
    return st, stack_frames(outs)


def scan_videos(step_fn, cfg, init, dets):
    """Step V videos at once over their frames: every field of ``dets``
    has leading (V, F) axes and ``init`` a leading V axis. Returns the
    final state and the outputs with leading (V, F) axes, the counterpart
    of ``jax.vmap(lambda d: scan(cfg, d))``."""
    st, outs = init, []
    for f in range(dets.ltrb.shape[1]):
        st, out = step_fn(cfg, st, Detections(*(x[:, f] for x in dets)))
        outs.append(out)
    return st, stack_frames(outs, dim=1)


def stack_frames(items, dim: int = 0):
    """Stack a list of per-frame NamedTuples along a new axis ``dim``;
    fields that are None stay None."""
    return type(items[0])(*(None if f[0] is None else torch.stack(f, dim)
                            for f in zip(*items)))


def concat_resets(n_videos: int, n_frames: int, device=None):
    """(V*F,) bool mask marking each video's first frame in a
    time-concatenated stream."""
    r = torch.zeros((n_videos, n_frames), dtype=torch.bool,
                    device=resolve_device(device))
    r[:, 0] = True
    return r.reshape(-1)
