"""ByteTrack as a per-frame step on tensors (counterpart of
tracklab_tpu.trackers.bytetrack).

The reference's tracked/lost/removed STrack lists become one slot array
with a per-slot state (TRACKED/LOST) and an active mask; its shared 8-dim
xyah Kalman filter is ``XYAHFilter``; ``lap.lapjv(cost_limit=thresh)`` is
``matching_limit`` (byte_tracker.py:151-320 and matching.py). The
two-stage high/low-score association, the unconfirmed-track stage, the
score-fused IoU cost and the duplicate suppression between tracked and lost
tracks follow the JAX package step for step, including its one documented
deviation from the reference: association runs on true ltrb boxes.

As in ``trackers/ocsort.py`` one implementation steps V videos at once
over a leading video axis; on one video's tensors the axis is added and
dropped again. Each of the three association stages is one solve launch
for all V videos: K1 in the default mode (videos whose candidate graph is
a unique partial matching skip it on the device), K2 with ``cfg.batched``.
A step issues no host sync.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import torch

from tracklab_torch.device import resolve_device
from tracklab_torch.ops import boxes as B
from tracklab_torch.ops.assignment import matching_limit
from tracklab_torch.ops.kalman import XYAHFilter as KF
from tracklab_torch.trackers.common import (Detections, birth_scatter,
                                            claim_slots, invert_match,
                                            repeat_state, scan_frames,
                                            scan_videos, single_video,
                                            take_rows)

__all__ = ["ByteTrackConfig", "ByteTrackState", "ByteTrackOutput",
           "bytetrack_init", "bytetrack_step", "bytetrack_scan",
           "bytetrack_scan_videos"]

TRACKED = 1
LOST = 2


@dataclass(frozen=True)
class ByteTrackConfig:
    """Defaults mirror the reference bytetrack.yaml and BYTETracker.__init__
    (byte_tracker.py:152-165). ``batched=True`` is the JAX package's
    cond-free multi-video mode (one rectangular solve per video and stage,
    K2); outputs are identical to the default mode."""
    track_thresh: float = 0.6
    match_thresh: float = 0.8
    track_buffer: int = 25
    frame_rate: int = 30
    batched: bool = False
    max_tracks: int = 128
    max_dets: int = 64

    @property
    def det_thresh(self) -> float:
        return self.track_thresh + 0.1

    @property
    def max_time_lost(self) -> int:
        return int(self.frame_rate / 30.0 * self.track_buffer)


class ByteTrackState(NamedTuple):
    """Slot state of one video; with a leading video axis every field
    gains a first dimension V (next_id and frame_count become (V,))."""
    mean: torch.Tensor          # (T, 8) xyah + velocities
    cov: torch.Tensor           # (T, 8, 8)
    tstate: torch.Tensor        # (T,) int32 TRACKED/LOST
    is_activated: torch.Tensor  # (T,) bool
    score: torch.Tensor         # (T,)
    cls: torch.Tensor           # (T,)
    ref: torch.Tensor           # (T,) int32
    track_id: torch.Tensor      # (T,) int32 0-based (emitted +1)
    frame_id: torch.Tensor      # (T,) int32 frame of last update
    start_frame: torch.Tensor   # (T,) int32
    tracklet_len: torch.Tensor  # (T,) int32
    active: torch.Tensor        # (T,) bool (removed == inactive)
    next_id: torch.Tensor       # () int32
    frame_count: torch.Tensor   # () int32


class ByteTrackOutput(NamedTuple):
    """Per-frame emission, slot-indexed with a validity mask."""
    ltrb: torch.Tensor
    track_id: torch.Tensor
    cls: torch.Tensor
    conf: torch.Tensor
    ref: torch.Tensor
    valid: torch.Tensor


def bytetrack_init(cfg: ByteTrackConfig, dtype=torch.float32,
                   device=None) -> ByteTrackState:
    """Empty tracker state on ``device`` (``cuda`` unless told otherwise)."""
    dev = resolve_device(device)
    T = cfg.max_tracks
    i32 = torch.int32
    f = partial(torch.zeros, dtype=dtype, device=dev)
    fi = partial(torch.zeros, dtype=i32, device=dev)
    fb = partial(torch.zeros, dtype=torch.bool, device=dev)
    return ByteTrackState(
        mean=f((T, 8)), cov=f((T, 8, 8)), tstate=fi(T),
        is_activated=fb(T), score=f(T), cls=f(T),
        ref=torch.full((T,), -1, dtype=i32, device=dev),
        track_id=fi(T), frame_id=fi(T), start_frame=fi(T),
        tracklet_len=fi(T), active=fb(T),
        next_id=fi(()), frame_count=fi(()),
    )


def _track_ltrb(mean):
    """KF mean -> ltrb (byte_tracker.py:96-117 tlwh/tlbr)."""
    cx, cy, a, h = mean[..., 0], mean[..., 1], mean[..., 2], mean[..., 3]
    w = a * h
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def _iou_dist(trk_ltrb, trk_mask, det_ltrb, det_mask):
    """1 - IoU (V, D, T), 1 on masked pairs."""
    iou = B.iou_matrix(det_ltrb, trk_ltrb)
    ok = det_mask[:, :, None] & trk_mask[:, None, :]
    return torch.where(ok, 1.0 - iou, 1.0)


def _fuse_score(dist, det_conf):
    """matching.py fuse_score: cost = 1 - (1 - dist) * det_score."""
    return 1.0 - (1.0 - dist) * det_conf[..., None]


def _kf_update_where(st: ByteTrackState, det: Detections, trk2det, now):
    """KF update and bookkeeping for tracks with trk2det >= 0: both
    update() and re_activate() (byte_tracker.py:59-94). tracklet_len
    continues for Tracked tracks and resets for re-activated Lost ones;
    both set state=Tracked and is_activated=True."""
    matched = trk2det >= 0
    safe = torch.where(matched, trk2det, 0)
    z = B.ltwh_to_xyah(B.ltrb_to_ltwh(take_rows(det.ltrb, safe)))
    upd_mean, upd_cov = KF.update(st.mean, st.cov, z)
    was_tracked = st.tstate == TRACKED
    new_len = torch.where(was_tracked, st.tracklet_len + 1, 0)
    return st._replace(
        mean=torch.where(matched[..., None], upd_mean, st.mean),
        cov=torch.where(matched[..., None, None], upd_cov, st.cov),
        tstate=torch.where(matched, TRACKED, st.tstate),
        is_activated=st.is_activated | matched,
        score=torch.where(matched, take_rows(det.conf, safe), st.score),
        cls=torch.where(matched, take_rows(det.cls, safe), st.cls),
        ref=torch.where(matched, take_rows(det.ref, safe), st.ref),
        frame_id=torch.where(matched, now[:, None], st.frame_id),
        tracklet_len=torch.where(matched, new_len, st.tracklet_len),
    )


def bytetrack_step(cfg: ByteTrackConfig, st: ByteTrackState,
                   det: Detections):
    """One frame; mirrors BYTETracker.update (byte_tracker.py:167-320).
    Takes one video's state and detections, or V videos' with a leading
    video axis."""
    if det.ltrb.dim() == 2:
        return single_video(_step, cfg, st, det)
    return _step(cfg, st, det)


def _step(cfg: ByteTrackConfig, st: ByteTrackState, det: Detections):
    """:func:`bytetrack_step` over a leading video axis."""
    T = cfg.max_tracks
    V, D = det.ltrb.shape[:2]
    dev = det.ltrb.device
    i32 = torch.int32
    now = st.frame_count + 1                               # (V,)
    st = st._replace(frame_count=now)

    first = det.valid & (det.conf > cfg.track_thresh)
    second = det.valid & (det.conf > 0.1) & (det.conf < cfg.track_thresh)

    unconfirmed = st.active & (st.tstate == TRACKED) & (~st.is_activated)
    tracked_act = st.active & (st.tstate == TRACKED) & st.is_activated
    pool = tracked_act | (st.active & (st.tstate == LOST))

    # multi_predict on the pool only (byte_tracker.py:32-43,223): lost
    # tracks get vh zeroed before predicting; unconfirmed are NOT predicted
    zero_vh = torch.cat([st.mean[..., :7], torch.zeros_like(st.mean[..., 7:])],
                        dim=-1)
    mean_in = torch.where((pool & (st.tstate != TRACKED))[..., None],
                          zero_vh, st.mean)
    pred_mean, pred_cov = KF.predict(mean_in, st.cov)
    st = st._replace(
        mean=torch.where(pool[..., None], pred_mean, st.mean),
        cov=torch.where(pool[..., None, None], pred_cov, st.cov),
    )

    # stage 1: high-score dets vs pool, score-fused IoU
    dist = _fuse_score(_iou_dist(_track_ltrb(st.mean), pool, det.ltrb,
                                 first), det.conf)
    d2t_1 = matching_limit(dist, first, pool, cfg.match_thresh,
                           batched=cfg.batched)
    t2d_1 = invert_match(d2t_1, T)
    st = _kf_update_where(st, det, t2d_1, now)

    # stage 2: low-score dets vs remaining *Tracked* pool tracks
    r_tracked = tracked_act & (t2d_1 < 0)
    dist2 = _iou_dist(_track_ltrb(st.mean), r_tracked, det.ltrb, second)
    d2t_2 = matching_limit(dist2, second, r_tracked, 0.5,
                           batched=cfg.batched)
    t2d_2 = invert_match(d2t_2, T)
    st = _kf_update_where(st, det, t2d_2, now)
    # unmatched stage-2 Tracked tracks -> Lost
    to_lost = r_tracked & (t2d_2 < 0)
    st = st._replace(tstate=torch.where(to_lost, LOST, st.tstate))

    # stage 3: leftover high-score dets vs unconfirmed tracks
    u_det = first & (d2t_1 < 0)
    dist3 = _fuse_score(_iou_dist(_track_ltrb(st.mean), unconfirmed,
                                  det.ltrb, u_det), det.conf)
    d2t_3 = matching_limit(dist3, u_det, unconfirmed, 0.7,
                           batched=cfg.batched)
    t2d_3 = invert_match(d2t_3, T)
    st = _kf_update_where(st, det, t2d_3, now)
    # unmatched unconfirmed -> removed
    st = st._replace(active=st.active & ~(unconfirmed & (t2d_3 < 0)))

    # births: leftover dets above det_thresh (byte_tracker.py:280-286)
    leftover = u_det & (d2t_3 < 0) & (det.conf >= cfg.det_thresh)
    det2slot = claim_slots(~st.active, leftover)
    birth = det2slot >= 0

    def scat(arr, val):
        return birth_scatter(det2slot, birth, arr, val)

    init_mean, init_cov = KF.initiate(B.ltwh_to_xyah(B.ltrb_to_ltwh(
        det.ltrb)))
    birth_ids = (st.next_id[:, None]
                 + torch.cumsum(birth.to(i32), 1, dtype=i32) - 1)
    now_d = now[:, None].expand(V, D)
    st = st._replace(
        mean=scat(st.mean, init_mean),
        cov=scat(st.cov, init_cov),
        tstate=scat(st.tstate, torch.full((), TRACKED, dtype=i32,
                                          device=dev)),
        is_activated=scat(st.is_activated, now_d == 1),  # only frame 1
        score=scat(st.score, det.conf),
        cls=scat(st.cls, det.cls),
        ref=scat(st.ref, det.ref),
        track_id=scat(st.track_id, birth_ids),
        frame_id=scat(st.frame_id, now_d),
        start_frame=scat(st.start_frame, now_d),
        tracklet_len=scat(st.tracklet_len, torch.zeros((), dtype=i32,
                                                       device=dev)),
        active=scat(st.active, birth),
        next_id=st.next_id + birth.sum(dim=1, dtype=i32),
    )

    # evict stale lost tracks (byte_tracker.py:288-291)
    stale = (st.active & (st.tstate == LOST)
             & (now[:, None] - st.frame_id > cfg.max_time_lost))
    st = st._replace(active=st.active & ~stale)

    # duplicate suppression tracked vs lost (byte_tracker.py:348-361)
    cur_ltrb = _track_ltrb(st.mean)
    trk_mask = st.active & (st.tstate == TRACKED)
    lost_mask = st.active & (st.tstate == LOST)
    iou = B.iou_matrix(cur_ltrb, cur_ltrb)                 # (V, T, T)
    pair = trk_mask[:, :, None] & lost_mask[:, None, :]
    dup = pair & ((1.0 - iou) < 0.15)
    life = st.frame_id - st.start_frame
    # tracked p vs lost q: drop q if life_p > life_q else drop p
    drop_lost = torch.any(dup & (life[:, :, None] > life[:, None, :]), dim=1)
    drop_trk = torch.any(dup & (life[:, :, None] <= life[:, None, :]), dim=2)
    st = st._replace(active=st.active & ~(drop_lost | drop_trk))

    emit = st.active & (st.tstate == TRACKED) & st.is_activated
    out = ByteTrackOutput(ltrb=cur_ltrb, track_id=st.track_id + 1,
                          cls=st.cls, conf=st.score, ref=st.ref, valid=emit)
    return st, out


def bytetrack_scan(cfg: ByteTrackConfig, dets: Detections,
                   init: ByteTrackState | None = None, resets=None):
    """Track a whole padded video: ``dets`` fields have a leading frame
    axis. Returns (final_state, ByteTrackOutput with a leading frame axis).
    ``resets`` (F,) bool re-initializes the carry at marked frames."""
    if init is None:
        init = bytetrack_init(cfg, dets.ltrb.dtype, dets.ltrb.device)
    return scan_frames(partial(bytetrack_step, cfg), init, dets, resets)


def bytetrack_scan_videos(cfg: ByteTrackConfig, dets: Detections):
    """Track V padded videos at once, one frame step for all of them:
    every field of ``dets`` has leading (V, F) axes. Returns (final_state
    with a leading V axis, ByteTrackOutput with leading (V, F) axes); each
    video's output equals its own :func:`bytetrack_scan`. The counterpart
    of ``jax.vmap(lambda d: bytetrack_scan(cfg, d))``."""
    init = repeat_state(bytetrack_init(cfg, dets.ltrb.dtype,
                                       dets.ltrb.device), dets.ltrb.shape[0])
    return scan_videos(_step, cfg, init, dets)
