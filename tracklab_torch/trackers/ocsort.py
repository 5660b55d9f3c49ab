"""OC-SORT as a per-frame step on tensors (counterpart of
tracklab_tpu.trackers.ocsort).

The state is a ``NamedTuple`` of fixed-capacity slot tensors; a step is a
pure function ``(cfg, state, Detections) -> (state, OCSortOutput)``. One
implementation steps V videos at once over a leading video axis (state
fields (V, T, ...), detections (V, D, ...)), the counterpart of the JAX
step under ``jax.vmap``; on one video's tensors the axis is added and
dropped again. The JAX package's ``lax.cond`` fast paths become
device-side selections (``torch.where``), and each association stage's
solves are one launch for all V videos with an ``active`` flag set on the
device: K1 in the default mode, K2 with ``cfg.batched`` (the cond-free
rectangular form). On the card a step issues no host sync: the ORU replay
runs as one kernel launch (``kernels/oru_replay.py``), each slot to its own
gap. Semantics match the reference step for step
(ocsort.py:203-334 and association.py:242-298).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import torch

from tracklab_torch.device import resolve_device
from tracklab_torch.ops import boxes as B
from tracklab_torch.ops.assignment import greedy_unique_match, matching_forced
from tracklab_torch.ops.kalman import XYSRFilter as KF
from tracklab_torch.trackers.common import (Detections, birth_scatter,
                                            claim_slots, invert_match,
                                            repeat_state, scan_frames,
                                            scan_videos, single_video,
                                            take_rows)

__all__ = ["OCSortConfig", "OCSortState", "OCSortOutput", "ocsort_init",
           "ocsort_step", "ocsort_scan", "ocsort_scan_videos"]

ASSO_FUNCS = {
    "iou": B.iou_matrix,
    "giou": B.giou_matrix,
    "diou": B.diou_matrix,
    "ciou": B.ciou_matrix,
}


@dataclass(frozen=True)
class OCSortConfig:
    """Mirrors the reference constructor defaults (ocsort.py:186-201) and
    tracklab's tuned oc_sort.yaml. ``angle_cost_scale="category"``
    reproduces the reference's use of the class column as the
    velocity-cost scale; "confidence" restores the OC-SORT paper's intent.
    ``batched=True`` is the JAX package's cond-free multi-video mode: every
    association stage is one rectangular solve per video (K2), with no
    fast paths; outputs are identical to the default mode."""
    det_thresh: float = 0.4432
    max_age: int = 50
    min_hits: int = 1
    iou_threshold: float = 0.2214
    delta_t: int = 3
    asso_func: str = "iou"
    inertia: float = 0.3941
    use_byte: bool = False
    angle_cost_scale: str = "category"
    batched: bool = False
    max_tracks: int = 128
    max_dets: int = 64


class OCSortState(NamedTuple):
    """Slot state of one video; with a leading video axis every field
    gains a first dimension V (next_id and frame_count become (V,))."""
    kf_x: torch.Tensor          # (T, 7)
    kf_P: torch.Tensor          # (T, 7, 7)
    frozen_x: torch.Tensor      # (T, 7) ORU snapshot
    frozen_P: torch.Tensor      # (T, 7, 7)
    observed: torch.Tensor      # (T,) bool: last update was a real obs
    has_frozen: torch.Tensor    # (T,) bool: a freeze snapshot exists
    last_obs: torch.Tensor      # (T, 5) ltrb+conf of last real observation
    has_obs: torch.Tensor       # (T,) bool: ever observed (post-birth)
    last_obs_age: torch.Tensor  # (T,) int32 age at last real observation
    obs_ring: torch.Tensor      # (T, delta_t+1, 5) observation ring buffer
    ring_age: torch.Tensor      # (T, delta_t+1) int32 age per slot (-1)
    velocity: torch.Tensor      # (T, 2) (dy, dx); zeros when None
    age: torch.Tensor           # (T,) int32
    time_since_update: torch.Tensor  # (T,) int32
    hits: torch.Tensor          # (T,) int32
    hit_streak: torch.Tensor    # (T,) int32
    track_id: torch.Tensor      # (T,) int32 (0-based; emitted +1)
    cls: torch.Tensor           # (T,) float
    conf: torch.Tensor          # (T,) float
    ref: torch.Tensor           # (T,) int32 caller row id of last match
    active: torch.Tensor        # (T,) bool
    next_id: torch.Tensor       # () int32
    frame_count: torch.Tensor   # () int32


class OCSortOutput(NamedTuple):
    """Per-frame emission, slot-indexed with a validity mask."""
    ltrb: torch.Tensor      # (T, 4)
    track_id: torch.Tensor  # (T,) int32, 1-based like the reference
    cls: torch.Tensor       # (T,)
    conf: torch.Tensor      # (T,)
    ref: torch.Tensor       # (T,) int32 detection row id matched
    valid: torch.Tensor     # (T,) bool


def ocsort_init(cfg: OCSortConfig, dtype=torch.float32,
                device=None) -> OCSortState:
    """Empty tracker state on ``device`` (``cuda`` unless told otherwise)."""
    dev = resolve_device(device)
    T, K = cfg.max_tracks, cfg.delta_t + 1
    i32 = torch.int32
    f = partial(torch.full, dtype=dtype, device=dev)
    fi = partial(torch.full, dtype=i32, device=dev)
    fb = partial(torch.zeros, dtype=torch.bool, device=dev)
    return OCSortState(
        kf_x=f((T, 7), 0.0), kf_P=f((T, 7, 7), 0.0),
        frozen_x=f((T, 7), 0.0), frozen_P=f((T, 7, 7), 0.0),
        observed=fb(T), has_frozen=fb(T),
        last_obs=f((T, 5), -1.0), has_obs=fb(T),
        last_obs_age=fi((T,), 0),
        obs_ring=f((T, K, 5), -1.0), ring_age=fi((T, K), -1),
        velocity=f((T, 2), 0.0),
        age=fi((T,), 0), time_since_update=fi((T,), 0),
        hits=fi((T,), 0), hit_streak=fi((T,), 0), track_id=fi((T,), 0),
        cls=f((T,), 0.0), conf=f((T,), 0.0), ref=fi((T,), -1),
        active=fb(T),
        next_id=fi((), 0), frame_count=fi((), 0),
    )


def _k_previous_obs(st: OCSortState, cfg: OCSortConfig):
    """Per track, the observation from delta_t frames ago, else the nearest
    more recent one, else the latest observation ever; -1s when none."""
    K = cfg.delta_t + 1
    cur = st.age
    fallback = torch.where(st.has_obs[..., None], st.last_obs,
                           torch.full_like(st.last_obs, -1.0))
    best_age = torch.full_like(cur, 2 ** 30)
    best_obs = fallback
    for k in range(K):
        a = st.ring_age[..., k]
        valid = (a >= 0) & (a >= cur - cfg.delta_t) & (a < cur)
        better = valid & (a < best_age)
        best_age = torch.where(better, a, best_age)
        best_obs = torch.where(better[..., None], st.obs_ring[..., k, :],
                               best_obs)
    return best_obs


def _speed_direction_cost(det_ltrb, det_scale, det_valid, k_obs, velocity,
                          trk_valid, inertia):
    """angle_diff_cost of associate() (association.py:246-265), (V, D, T)."""
    dcx = (det_ltrb[..., 0] + det_ltrb[..., 2]) * 0.5
    dcy = (det_ltrb[..., 1] + det_ltrb[..., 3]) * 0.5
    tcx = (k_obs[..., 0] + k_obs[..., 2]) * 0.5
    tcy = (k_obs[..., 1] + k_obs[..., 3]) * 0.5
    dx = dcx[:, None, :] - tcx[:, :, None]      # (V, T, D)
    dy = dcy[:, None, :] - tcy[:, :, None]
    norm = torch.sqrt(dx * dx + dy * dy) + 1e-6
    X, Y = dx / norm, dy / norm
    cos = velocity[..., 1:2] * X + velocity[..., 0:1] * Y
    cos = torch.clamp(cos, -1.0, 1.0)
    diff_angle = (math.pi / 2.0 - torch.abs(torch.arccos(cos))) / math.pi
    valid_mask = (k_obs[..., 4] >= 0).to(det_ltrb.dtype)[..., None]
    cost = (valid_mask * diff_angle) * inertia   # (V, T, D)
    cost = cost.transpose(1, 2) * det_scale[..., None]    # (V, D, T)
    return torch.where(det_valid[:, :, None] & trk_valid[:, None, :],
                       cost, 0.0)


def _no_match(shape, device):
    return torch.full(shape, -1, dtype=torch.int32, device=device)


def _post_filter(det2trk, iou, thr):
    """Drop matches whose IoU is under the threshold (keep iou >= thr)."""
    got = det2trk >= 0
    safe = torch.where(got, det2trk, 0).long()
    keep = got & (iou.gather(2, safe[..., None])[..., 0] >= thr)
    return torch.where(keep, det2trk, -1)


def _pair_masked(sim, det_valid, trk_valid):
    return torch.where(det_valid[:, :, None] & trk_valid[:, None, :], sim,
                       0.0)


def _associate(cfg, det_ltrb, det_scale, det_valid, trk_ltrb, trk_valid,
               k_obs, velocity):
    """First-round association (association.py:242-298): det2trk (V, D)
    int32. Stage 1 always scores with plain IoU; asso_func applies to the
    recovery stages only. Default mode: when no pair of a video clears the
    threshold nothing can survive the post-filter, and a unique greedy
    matching is the answer: in both cases that video's solve is switched
    off on the device. Batched mode: one rectangular solve per video."""
    iou = _pair_masked(B.iou_matrix(det_ltrb, trk_ltrb), det_valid,
                       trk_valid)
    angle = _speed_direction_cost(det_ltrb, det_scale, det_valid, k_obs,
                                  velocity, trk_valid, cfg.inertia)
    if cfg.batched:
        det2trk = matching_forced(-(iou + angle), det_valid, trk_valid,
                                  batched=True)
    else:
        is_unique, greedy = greedy_unique_match(iou, det_valid, trk_valid,
                                                cfg.iou_threshold)
        none_feasible = iou.amax(dim=(1, 2)) < cfg.iou_threshold
        solved = matching_forced(-(iou + angle), det_valid, trk_valid,
                                 need=~none_feasible & ~is_unique)
        det2trk = torch.where(
            none_feasible[:, None], _no_match(det_valid.shape, iou.device),
            torch.where(is_unique[:, None], greedy, solved))
    return _post_filter(det2trk, iou, cfg.iou_threshold)


def _recovery_match(cfg, det_ltrb, det_valid, trk_ltrb, trk_valid):
    """The BYTE (ocsort.py:264-282) and OCR (ocsort.py:284-306) stages:
    gated per video on max similarity, LSA on -sim, post-filter by
    iou_threshold. A video whose gate is closed skips its solve on the
    device in both modes."""
    iou = _pair_masked(ASSO_FUNCS[cfg.asso_func](det_ltrb, trk_ltrb),
                       det_valid, trk_valid)
    gate = iou.amax(dim=(1, 2)) > cfg.iou_threshold
    det2trk = matching_forced(-iou, det_valid, trk_valid, need=gate,
                              batched=cfg.batched)
    det2trk = _post_filter(det2trk, iou, cfg.iou_threshold)
    return torch.where(gate[:, None], det2trk, -1)


def _apply_updates(cfg, st: OCSortState, det: Detections, trk2det):
    """KF update (+ ORU replay) and bookkeeping for matched tracks.
    trk2det: (V, T) int32, -1 where unmatched."""
    matched = trk2det >= 0
    safe_det = torch.where(matched, trk2det, 0)
    z_ltrb = take_rows(det.ltrb, safe_det)
    z_conf = take_rows(det.conf, safe_det)
    z_cls = take_rows(det.cls, safe_det)
    z_ref = take_rows(det.ref, safe_det)
    z = B.ltrb_to_xysr(z_ltrb)

    # ORU: tracks re-observed after a gap rewind to the frozen state
    need_oru = matched & st.active & (~st.observed) & st.has_frozen
    gap = torch.clamp(st.age - st.last_obs_age, min=1)
    z_prev = B.ltrb_to_xysr(st.last_obs[..., :4])
    replay_x, replay_P = KF.oru_replay_batch(
        st.frozen_x, st.frozen_P, z_prev, z, gap, need_oru)
    base_x = torch.where(need_oru[..., None], replay_x, st.kf_x)
    base_P = torch.where(need_oru[..., None, None], replay_P, st.kf_P)

    upd_x, upd_P = KF.update(base_x, base_P, z)
    new_x = torch.where(matched[..., None], upd_x, st.kf_x)
    new_P = torch.where(matched[..., None, None], upd_P, st.kf_P)

    # velocity from the delta_t-past observation (ocsort.py:117-129)
    k_obs_upd = _k_previous_obs(st, cfg)
    prev_box = torch.where((k_obs_upd[..., 4] >= 0)[..., None],
                           k_obs_upd[..., :4], st.last_obs[..., :4])
    pcx = (prev_box[..., 0] + prev_box[..., 2]) * 0.5
    pcy = (prev_box[..., 1] + prev_box[..., 3]) * 0.5
    ncx = (z_ltrb[..., 0] + z_ltrb[..., 2]) * 0.5
    ncy = (z_ltrb[..., 1] + z_ltrb[..., 3]) * 0.5
    d = torch.stack([ncy - pcy, ncx - pcx], dim=-1)
    speed = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-6)
    set_vel = matched & st.has_obs
    velocity = torch.where(set_vel[..., None], speed, st.velocity)

    # observation bookkeeping: one-hot write into the tiny ring
    obs5 = torch.cat([z_ltrb, z_conf[..., None]], dim=-1)
    last_obs = torch.where(matched[..., None], obs5, st.last_obs)
    K = cfg.delta_t + 1
    slot = torch.remainder(st.age, K)
    write = ((torch.arange(K, dtype=torch.int32, device=slot.device)
              == slot[..., None]) & matched[..., None])
    ring_obs = torch.where(write[..., None], obs5[..., None, :], st.obs_ring)
    ring_age = torch.where(write, st.age[..., None], st.ring_age)
    m_i = matched.to(torch.int32)
    return st._replace(
        kf_x=new_x, kf_P=new_P,
        observed=st.observed | matched,
        last_obs=last_obs,
        has_obs=st.has_obs | matched,
        last_obs_age=torch.where(matched, st.age, st.last_obs_age),
        obs_ring=ring_obs, ring_age=ring_age,
        velocity=velocity,
        time_since_update=torch.where(matched, 0, st.time_since_update),
        hits=st.hits + m_i,
        hit_streak=st.hit_streak + m_i,
        cls=torch.where(matched, z_cls, st.cls),
        conf=torch.where(matched, z_conf, st.conf),
        ref=torch.where(matched, z_ref, st.ref),
    )


def ocsort_step(cfg: OCSortConfig, st: OCSortState, det: Detections):
    """One frame of OC-SORT; mirrors OCSort.update (ocsort.py:203-334).
    Takes one video's state and detections, or V videos' with a leading
    video axis."""
    if det.ltrb.dim() == 2:
        return single_video(_step, cfg, st, det)
    return _step(cfg, st, det)


def _step(cfg: OCSortConfig, st: OCSortState, det: Detections):
    """:func:`ocsort_step` over a leading video axis."""
    T = cfg.max_tracks
    V, D = det.ltrb.shape[:2]
    dev = det.ltrb.device
    dt = st.kf_x.dtype
    i32 = torch.int32
    st = st._replace(frame_count=st.frame_count + 1)

    conf = det.conf
    first_valid = det.valid & (conf > cfg.det_thresh)
    second_valid = det.valid & (conf > 0.1) & (conf < cfg.det_thresh)

    # predict all active tracks (ocsort.py:234-244)
    pred_x, pred_P = KF.predict(st.kf_x, st.kf_P)
    pred_x = torch.where(st.active[..., None], pred_x, st.kf_x)
    pred_P = torch.where(st.active[..., None, None], pred_P, st.kf_P)
    trk_ltrb = KF.to_ltrb(pred_x)
    finite = torch.isfinite(trk_ltrb).all(dim=-1)
    active = st.active & finite                        # NaN tracks dropped
    a_i = active.to(i32)
    st = st._replace(
        kf_x=pred_x, kf_P=pred_P, active=active,
        age=st.age + a_i,
        hit_streak=torch.where(st.time_since_update > 0, 0, st.hit_streak),
        time_since_update=st.time_since_update + a_i,
    )

    # stage 1: OCM association on high-score dets
    k_obs = _k_previous_obs(st, cfg)
    angle_scale = det.cls if cfg.angle_cost_scale == "category" else det.conf
    det2trk = _associate(cfg, det.ltrb, angle_scale, first_valid, trk_ltrb,
                         st.active, k_obs, st.velocity)
    trk_matched_1 = invert_match(det2trk, T) >= 0

    # stage 2 (BYTE, optional): low-score dets vs unmatched tracks
    if cfg.use_byte:
        u_trk = st.active & ~trk_matched_1
        byte_d2t = _recovery_match(cfg, det.ltrb, second_valid, trk_ltrb,
                                   u_trk)
    else:
        byte_d2t = _no_match((V, D), dev)

    # stage 3 (OCR): unmatched dets vs unmatched tracks' last obs
    trk_matched_2 = trk_matched_1 | (invert_match(byte_d2t, T) >= 0)
    u_det = first_valid & (det2trk < 0)
    u_trk = st.active & ~trk_matched_2
    ocr_d2t = _recovery_match(cfg, det.ltrb, u_det, st.last_obs[..., :4],
                              u_trk & st.has_obs)

    combined_d2t = torch.where(det2trk >= 0, det2trk,
                               torch.where(byte_d2t >= 0, byte_d2t, ocr_d2t))
    trk2det = invert_match(combined_d2t, T)
    trk2det = torch.where(st.active, trk2det, -1)

    # freeze ORU snapshots for tracks going unobserved this frame
    unmatched_trk = st.active & (trk2det < 0)
    freeze_now = unmatched_trk & st.observed
    st = st._replace(
        frozen_x=torch.where(freeze_now[..., None], st.kf_x, st.frozen_x),
        frozen_P=torch.where(freeze_now[..., None, None], st.kf_P,
                             st.frozen_P),
        has_frozen=st.has_frozen | freeze_now,
        observed=st.observed & ~unmatched_trk,
    )

    st = _apply_updates(cfg, st, det, trk2det)

    # births: unmatched high-score dets claim free slots
    still_unmatched = first_valid & (combined_d2t < 0)
    det2slot = claim_slots(~st.active, still_unmatched)
    birth = det2slot >= 0
    n_birth = birth.sum(dim=1, dtype=i32)

    def scat(arr, val):
        return birth_scatter(det2slot, birth, arr, val)

    z0 = B.ltrb_to_xysr(det.ltrb)
    init_x = torch.cat([z0, torch.zeros((V, D, 3), dtype=dt, device=dev)],
                       -1)
    _, _, _, P0, _ = KF.constants(dt, dev)
    birth_ids = (st.next_id[:, None]
                 + torch.cumsum(birth.to(i32), 1, dtype=i32) - 1)
    K = cfg.delta_t + 1
    zf = partial(torch.zeros, dtype=dt, device=dev)
    zi = partial(torch.zeros, dtype=i32, device=dev)
    zb = partial(torch.zeros, dtype=torch.bool, device=dev)
    st = st._replace(
        kf_x=scat(st.kf_x, init_x),
        kf_P=scat(st.kf_P, P0),
        frozen_x=scat(st.frozen_x, zf(())),
        frozen_P=scat(st.frozen_P, zf(())),
        observed=scat(st.observed, zb(())),
        has_frozen=scat(st.has_frozen, zb(())),
        last_obs=scat(st.last_obs, torch.full((), -1.0, dtype=dt,
                                              device=dev)),
        has_obs=scat(st.has_obs, zb(())),
        last_obs_age=scat(st.last_obs_age, zi(())),
        obs_ring=scat(st.obs_ring, torch.full((), -1.0, dtype=dt,
                                              device=dev)),
        ring_age=scat(st.ring_age, torch.full((), -1, dtype=i32,
                                              device=dev)),
        velocity=scat(st.velocity, zf(())),
        age=scat(st.age, zi(())),
        time_since_update=scat(st.time_since_update, zi(())),
        hits=scat(st.hits, zi(())),
        hit_streak=scat(st.hit_streak, zi(())),
        track_id=scat(st.track_id, birth_ids),
        cls=scat(st.cls, det.cls),
        conf=scat(st.conf, det.conf),
        ref=scat(st.ref, det.ref),
        active=scat(st.active, birth),
        next_id=st.next_id + n_birth,
    )

    # emit (ocsort.py:315-331)
    emit = (st.active & (st.time_since_update < 1)
            & ((st.hit_streak >= cfg.min_hits)
               | (st.frame_count[:, None] <= cfg.min_hits)))
    kf_box = KF.to_ltrb(st.kf_x)
    out_box = torch.where(st.has_obs[..., None], st.last_obs[..., :4],
                          kf_box)
    out = OCSortOutput(ltrb=out_box, track_id=st.track_id + 1, cls=st.cls,
                       conf=st.conf, ref=st.ref, valid=emit)

    # evict dead tracks (ocsort.py:330-331)
    st = st._replace(active=st.active
                     & (st.time_since_update <= cfg.max_age))
    return st, out


def ocsort_scan(cfg: OCSortConfig, dets: Detections,
                init: OCSortState | None = None, resets=None):
    """Track a whole padded video: ``dets`` fields have a leading frame
    axis. Returns (final_state, OCSortOutput with a leading frame axis).
    ``resets`` (F,) bool re-initializes the carry at marked frames."""
    if init is None:
        init = ocsort_init(cfg, dets.ltrb.dtype, dets.ltrb.device)
    return scan_frames(partial(ocsort_step, cfg), init, dets, resets)


def ocsort_scan_videos(cfg: OCSortConfig, dets: Detections):
    """Track V padded videos at once, one frame step for all of them:
    every field of ``dets`` has leading (V, F) axes. Returns (final_state
    with a leading V axis, OCSortOutput with leading (V, F) axes); each
    video's output equals its own :func:`ocsort_scan`. The counterpart of
    ``jax.vmap(lambda d: ocsort_scan(cfg, d))``, the per-shard body of the
    JAX package's multi-video mesh."""
    init = repeat_state(ocsort_init(cfg, dets.ltrb.dtype, dets.ltrb.device),
                        dets.ltrb.shape[0])
    return scan_videos(_step, cfg, init, dets)
