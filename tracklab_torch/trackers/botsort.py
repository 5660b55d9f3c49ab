"""BoT-SORT as a per-frame step on tensors (counterpart of
tracklab_tpu.trackers.botsort).

ByteTrack's two-stage lifecycle plus, step for step as the JAX package (the
reference bot_sort/bot_sort.py:236-486 and matching.py):

  * the xywh 8-dim Kalman filter (``ops/kalman.py:XYWHFilter``);
  * camera motion compensation: per-frame 2x3 warps applied to the means
    and covariances of the pool and the unconfirmed tracks before
    association (STrack.multi_gmc: mean' = kron(I4, R) mean + t, cov' = R8
    cov R8^T);
  * stage-1 cost fuse_motion: the cosine distance of the EMA-smoothed track
    features, Mahalanobis-gated (inf) and blended with the gating distance
    by lambda_;
  * the unconfirmed stage: min(score-fused IoU cost, halved embedding cost
    with appearance and proximity masking);
  * births gated by new_track_thresh.

One implementation steps V videos at once over a leading video axis (state
fields (V, T, ...), detections (V, D, ...)); on one video's tensors the
axis is added and dropped again. Each association stage is one solve launch
for all V videos: K1 in the default mode, K2 with ``cfg.batched``. A step
issues no host sync.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import torch

from tracklab_torch.device import resolve_device
from tracklab_torch.ops import boxes as B
from tracklab_torch.ops.assignment import matching_limit
from tracklab_torch.ops.embeddings import normalize_rows
from tracklab_torch.ops.kalman import CHI2INV95_4D
from tracklab_torch.ops.kalman import XYWHFilter as KF
from tracklab_torch.trackers.common import (Detections, birth_scatter,
                                            claim_slots, invert_match,
                                            kron_eye4, repeat_state,
                                            scan_inputs, scan_video_inputs,
                                            single_video, take_rows)

__all__ = ["BotSortConfig", "BotSortState", "BotSortOutput", "botsort_init",
           "botsort_step", "botsort_scan", "botsort_scan_videos"]

TRACKED = 1
LOST = 2


@dataclass(frozen=True)
class BotSortConfig:
    """Defaults mirror tracklab's configs/modules/track/bot_sort.yaml.
    ``batched=True`` is the cond-free multi-video mode (K2); each mode
    gives the JAX package's tracks in that mode."""
    track_high_thresh: float = 0.3382
    new_track_thresh: float = 0.2114
    track_buffer: int = 60
    match_thresh: float = 0.2273
    proximity_thresh: float = 0.5945
    appearance_thresh: float = 0.4818
    lambda_: float = 0.9896
    frame_rate: int = 30
    ema_alpha: float = 0.9
    embed_dim: int = 512
    batched: bool = False
    max_tracks: int = 128
    max_dets: int = 64

    @property
    def max_time_lost(self) -> int:
        return int(self.frame_rate / 30.0 * self.track_buffer)


class BotSortState(NamedTuple):
    """Slot state of one video; with a leading video axis every field
    gains a first dimension V (next_id and frame_count become (V,))."""
    mean: torch.Tensor          # (T, 8) xywh + velocities
    cov: torch.Tensor           # (T, 8, 8)
    feat: torch.Tensor          # (T, E) smoothed feature (normalised)
    has_feat: torch.Tensor      # (T,) bool
    tstate: torch.Tensor        # (T,) int32 TRACKED / LOST
    is_activated: torch.Tensor  # (T,) bool
    score: torch.Tensor
    cls: torch.Tensor
    ref: torch.Tensor
    track_id: torch.Tensor
    frame_id: torch.Tensor      # (T,) int32 frame of the last update
    start_frame: torch.Tensor
    active: torch.Tensor
    next_id: torch.Tensor       # () int32
    frame_count: torch.Tensor   # () int32


class BotSortOutput(NamedTuple):
    """Per-frame emission, slot-indexed with a validity mask."""
    ltrb: torch.Tensor
    track_id: torch.Tensor
    cls: torch.Tensor
    conf: torch.Tensor
    ref: torch.Tensor
    valid: torch.Tensor


def botsort_init(cfg: BotSortConfig, dtype=torch.float32,
                 device=None) -> BotSortState:
    """Empty tracker state on ``device`` (``cuda`` unless told otherwise)."""
    dev = resolve_device(device)
    T, E = cfg.max_tracks, cfg.embed_dim
    f = partial(torch.zeros, dtype=dtype, device=dev)
    fi = partial(torch.zeros, dtype=torch.int32, device=dev)
    fb = partial(torch.zeros, dtype=torch.bool, device=dev)
    return BotSortState(
        mean=f((T, 8)), cov=f((T, 8, 8)), feat=f((T, E)), has_feat=fb(T),
        tstate=fi(T), is_activated=fb(T), score=f(T), cls=f(T),
        ref=torch.full((T,), -1, dtype=torch.int32, device=dev),
        track_id=fi(T), frame_id=fi(T), start_frame=fi(T), active=fb(T),
        next_id=fi(()), frame_count=fi(()))


def _mean_to_ltrb(mean):
    """xywh KF mean (..., 8) -> ltrb (..., 4)."""
    return B.xywh_to_ltrb(mean[..., :4])


def _gmc_apply(mean, cov, warp, mask):
    """STrack.multi_gmc (bot_sort.py:94-108) per video: mean (V, T, 8), cov
    (V, T, 8, 8), warp (V, 2, 3), mask (V, T)."""
    R8 = kron_eye4(warp[:, :, :2])
    R8t = R8.transpose(-1, -2)[:, None]
    new_mean = mean @ R8t[:, 0]
    new_mean = torch.cat([new_mean[..., 0:2] + warp[:, None, :, 2],
                          new_mean[..., 2:]], dim=-1)
    new_cov = R8[:, None] @ cov @ R8t
    return (torch.where(mask[..., None], new_mean, mean),
            torch.where(mask[..., None, None], new_cov, cov))


def _kf_update_where(st, det, trk2det, emb_n, now, alpha):
    """KF update, feature EMA and bookkeeping of the tracks matched in
    ``trk2det`` (V, T); the EMA only where the detection has a feature
    (stage-2 detections have none, bot_sort.py:402)."""
    matched = trk2det >= 0
    safe = torch.where(matched, trk2det, 0)
    z = B.ltrb_to_xywh(take_rows(det.ltrb, safe))
    upd_mean, upd_cov = KF.update(st.mean, st.cov, z)
    new_feat = take_rows(emb_n, safe)
    has_new = matched & (torch.linalg.vector_norm(new_feat, dim=-1) > 1e-6)
    blended = normalize_rows(alpha * st.feat + (1 - alpha) * new_feat)
    feat = torch.where((has_new & st.has_feat)[..., None], blended,
                       torch.where(has_new[..., None], new_feat, st.feat))
    return st._replace(
        mean=torch.where(matched[..., None], upd_mean, st.mean),
        cov=torch.where(matched[..., None, None], upd_cov, st.cov),
        feat=feat, has_feat=st.has_feat | has_new,
        tstate=torch.where(matched, TRACKED, st.tstate),
        is_activated=st.is_activated | matched,
        score=torch.where(matched, take_rows(det.conf, safe), st.score),
        cls=torch.where(matched, take_rows(det.cls, safe), st.cls),
        ref=torch.where(matched, take_rows(det.ref, safe), st.ref),
        frame_id=torch.where(matched, now[:, None], st.frame_id))


def _emb_dist(feat, emb_n):
    """Cosine distance (V, D, T) of detection features to track features,
    clamped at 0 (the track-by-detection product, then transposed)."""
    return torch.clamp(1.0 - feat @ emb_n.transpose(-1, -2),
                       min=0.0).transpose(-1, -2)


def botsort_step(cfg: BotSortConfig, st: BotSortState, inputs):
    """One frame. ``inputs`` = (Detections, emb (D, E), warp (2, 3)) for
    one video, or each with a leading video axis V for a state with one."""
    if inputs[0].ltrb.dim() == 2:
        return single_video(_step, cfg, st, inputs)
    return _step(cfg, st, inputs)


def _step(cfg: BotSortConfig, st: BotSortState, inputs):
    """:func:`botsort_step` over a leading video axis."""
    det, emb, warp = inputs
    T = cfg.max_tracks
    dev = det.ltrb.device
    i32 = torch.int32
    now = st.frame_count + 1
    st = st._replace(frame_count=now)
    emb_n = torch.where(
        torch.linalg.vector_norm(emb, dim=-1, keepdim=True) > 1e-6,
        normalize_rows(emb), torch.zeros_like(emb))

    first = det.valid & (det.conf > cfg.track_high_thresh)
    second = (det.valid & (det.conf > 0.1)
              & (det.conf < cfg.track_high_thresh))
    tracked = st.active & (st.tstate == TRACKED)
    unconfirmed = tracked & ~st.is_activated
    tracked_act = tracked & st.is_activated
    pool = tracked_act | (st.active & (st.tstate == LOST))

    # predict the pool (vh zeroed for lost tracks), then GMC on the pool
    # and the unconfirmed tracks
    zero_vh = torch.cat([st.mean[..., :7], torch.zeros_like(st.mean[..., 7:])],
                        dim=-1)
    mean_in = torch.where((pool & (st.tstate != TRACKED))[..., None],
                          zero_vh, st.mean)
    pred_mean, pred_cov = KF.predict(mean_in, st.cov)
    mean = torch.where(pool[..., None], pred_mean, st.mean)
    cov = torch.where(pool[..., None, None], pred_cov, st.cov)
    mean, cov = _gmc_apply(mean, cov, warp, pool | unconfirmed)
    st = st._replace(mean=mean, cov=cov)

    # stage 1: fuse_motion cost on the pool
    det_xywh = B.ltrb_to_xywh(det.ltrb)
    gating = KF.gating_distance(st.mean, st.cov,
                                det_xywh).transpose(-1, -2)     # (V, D, T)
    cost1 = torch.where(gating > CHI2INV95_4D, torch.inf,
                        _emb_dist(st.feat, emb_n))
    cost1 = cfg.lambda_ * cost1 + (1 - cfg.lambda_) * gating
    # a pool track without a feature yet gives no appearance cost (the
    # reference attaches one to every pool track); rule it out
    cost1 = torch.where(st.has_feat[..., None, :], cost1, torch.inf)
    d2t_1 = matching_limit(cost1, first, pool, cfg.match_thresh,
                           batched=cfg.batched)
    t2d_1 = invert_match(d2t_1, T)
    st = _kf_update_where(st, det, t2d_1, emb_n, now, cfg.ema_alpha)

    # stage 2: low-score detections against the remaining tracked, IoU only
    r_tracked = tracked_act & (t2d_1 < 0)
    iou2 = B.iou_matrix(det.ltrb, _mean_to_ltrb(st.mean))
    ok2 = second[..., :, None] & r_tracked[..., None, :]
    dist2 = torch.where(ok2, 1.0 - iou2, 1.0)
    d2t_2 = matching_limit(dist2, second, r_tracked, 0.5,
                           batched=cfg.batched)
    t2d_2 = invert_match(d2t_2, T)
    st = _kf_update_where(st, det, t2d_2, torch.zeros_like(emb_n), now,
                          cfg.ema_alpha)
    st = st._replace(tstate=torch.where(r_tracked & (t2d_2 < 0), LOST,
                                        st.tstate))

    # stage 3: unconfirmed, min(IoU-fused, embedding) (bot_sort.py:420-432)
    u_det = first & (d2t_1 < 0)
    iou3 = B.iou_matrix(det.ltrb, _mean_to_ltrb(st.mean))
    ok3 = u_det[..., :, None] & unconfirmed[..., None, :]
    ious_dists = torch.where(ok3, 1.0 - iou3, 1.0)
    fused = 1.0 - (1.0 - ious_dists) * det.conf[..., None]
    emb3 = _emb_dist(st.feat, emb_n) / 2.0
    emb3 = torch.where(emb3 > cfg.appearance_thresh, 1.0, emb3)
    emb3 = torch.where(ious_dists > cfg.proximity_thresh, 1.0, emb3)
    emb3 = torch.where(st.has_feat[..., None, :], emb3, 1.0)
    d2t_3 = matching_limit(torch.minimum(fused, emb3), u_det, unconfirmed,
                           0.7, batched=cfg.batched)
    t2d_3 = invert_match(d2t_3, T)
    st = _kf_update_where(st, det, t2d_3, emb_n, now, cfg.ema_alpha)
    st = st._replace(active=st.active & ~(unconfirmed & (t2d_3 < 0)))

    # births (new_track_thresh)
    leftover = u_det & (d2t_3 < 0) & (det.conf >= cfg.new_track_thresh)
    det2slot = claim_slots(~st.active, leftover)
    birth = det2slot >= 0

    def scat(arr, val):
        return birth_scatter(det2slot, birth, arr, val)

    init_mean, init_cov = KF.initiate(det_xywh)
    birth_ids = (st.next_id[:, None]
                 + torch.cumsum(birth.to(i32), 1, dtype=i32) - 1)
    now_d = now[:, None].expand(birth.shape)
    st = st._replace(
        mean=scat(st.mean, init_mean), cov=scat(st.cov, init_cov),
        feat=scat(st.feat, emb_n),
        has_feat=scat(st.has_feat,
                      torch.linalg.vector_norm(emb_n, dim=-1) > 1e-6),
        tstate=scat(st.tstate, torch.full((), TRACKED, dtype=i32,
                                          device=dev)),
        is_activated=scat(st.is_activated, now_d == 1),
        score=scat(st.score, det.conf), cls=scat(st.cls, det.cls),
        ref=scat(st.ref, det.ref), track_id=scat(st.track_id, birth_ids),
        frame_id=scat(st.frame_id, now_d),
        start_frame=scat(st.start_frame, now_d),
        active=scat(st.active, birth),
        next_id=st.next_id + birth.sum(dim=1, dtype=i32))

    # stale lost tracks leave; duplicate suppression (as ByteTrack)
    stale = (st.active & (st.tstate == LOST)
             & (now[:, None] - st.frame_id > cfg.max_time_lost))
    st = st._replace(active=st.active & ~stale)
    cur_ltrb = _mean_to_ltrb(st.mean)
    trk_mask = st.active & (st.tstate == TRACKED)
    lost_mask = st.active & (st.tstate == LOST)
    iou = B.iou_matrix(cur_ltrb, cur_ltrb)
    dup = (trk_mask[..., :, None] & lost_mask[..., None, :]
           & ((1.0 - iou) < 0.15))
    life = st.frame_id - st.start_frame
    older = life[..., :, None] > life[..., None, :]
    drop_lost = (dup & older).any(dim=-2)
    drop_trk = (dup & ~older).any(dim=-1)
    st = st._replace(active=st.active & ~(drop_lost | drop_trk))

    emit = st.active & (st.tstate == TRACKED) & st.is_activated
    out = BotSortOutput(ltrb=cur_ltrb, track_id=st.track_id + 1, cls=st.cls,
                        conf=st.score, ref=st.ref, valid=emit)
    return st, out


def botsort_scan(cfg: BotSortConfig, dets: Detections, emb, warps=None,
                 init: BotSortState | None = None, resets=None):
    """Track one padded video: ``dets`` fields and ``emb`` (F, D, E) have a
    leading frame axis F, ``warps`` (F, 2, 3) (identity when None);
    ``resets`` (F,) bool re-initialises the carry at marked frames. Returns
    (final_state, BotSortOutput with a leading frame axis)."""
    if init is None:
        init = botsort_init(cfg, dets.ltrb.dtype, dets.ltrb.device)
    return scan_inputs(partial(botsort_step, cfg), init, dets, emb, warps,
                       resets)


def botsort_scan_videos(cfg: BotSortConfig, dets: Detections, emb,
                        warps=None):
    """Track V padded videos at once, one frame step for all of them:
    every input has leading (V, F) axes. Each video's output equals its own
    :func:`botsort_scan`; the counterpart of ``jax.vmap`` of the JAX scan."""
    init = repeat_state(botsort_init(cfg, dets.ltrb.dtype, dets.ltrb.device),
                        dets.ltrb.shape[0])
    return scan_video_inputs(partial(_step, cfg), init, dets, emb, warps)
