"""BPBReID-StrongSORT as a per-frame step on tensors (counterpart of
tracklab_tpu.trackers.bpbreid_strongsort).

StrongSORT driven by externally computed part-based ReID embeddings (KPR):
the part-based appearance distance (visibility-weighted mean over parts of
1 - cos), the visibility-aware part-feature EMA, a selectable motion cost
(IoU of the KF prediction, or OKS of the tracks' last keypoints), the
strong_sort cascade (a gated ReID stage on confirmed tracks, then the
motion stage) or the bot_sort single weighted assignment, the NSA Kalman
filter with its prediction freeze for long-coasting tracks, and the
Tentative/Confirmed lifecycle, step for step as the JAX package.

As in ``trackers/ocsort.py`` one implementation steps V videos at once over
a leading video axis; on one video's tensors the axis is added and dropped
again. Each association stage is one solve launch for all V videos: K1 in
the default mode (videos whose candidate graph is a unique partial
matching skip it on the device), K2 with ``cfg.batched``. A step issues no
host sync: the JAX package's ``lax.cond`` branches are selections.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Optional

import torch

from tracklab_torch.device import resolve_device
from tracklab_torch.ops import boxes as B
from tracklab_torch.ops.assignment import _take_cols
from tracklab_torch.ops.kalman import CHI2INV95_2D, CHI2INV95_4D
from tracklab_torch.ops.kalman import XYAHNSAHFilter as KF
from tracklab_torch.ops.oks import oks_matrix
from tracklab_torch.trackers.common import (Detections, birth_scatter,
                                            claim_slots, repeat_state,
                                            reset_wrapped_step, single_video,
                                            stack_frames, take_rows)
from tracklab_torch.trackers.strongsort import (_apply_warp,
                                                _clamped_matching, _invert,
                                                _mean_to_ltrb)

__all__ = ["BPBReIDStrongSortConfig", "BPBReIDStrongSortState",
           "BPBReIDStrongSortOutput", "bpbreid_init", "part_based_distance",
           "bpbreid_step", "bpbreid_scan", "bpbreid_scan_videos"]

TENTATIVE = 1
CONFIRMED = 2
INFTY_COST = 1e5


@dataclass(frozen=True)
class BPBReIDStrongSortConfig:
    """Defaults mirror the reference's bpbreid_strong_sort.yaml.
    ``matching_strategy``: "strong_sort" (gated ReID cascade, then the
    motion stage) or "bot_sort" (one assignment over the weighted sum of
    KF-gating, ReID and spatio-temporal costs). ``batched=True`` is the
    cond-free multi-video mode (K2); outputs are identical. ``emit_costs``
    adds the un-gated cost matrices and each detection's matched stage and
    cost to the output."""
    max_dist: float = 0.5
    motion_criterium: str = "iou"     # or "oks"
    max_iou_distance: float = 0.8
    max_oks_distance: float = 0.7
    max_age: int = 300
    n_init: int = 0
    mc_lambda: float = 0.995
    ema_alpha: float = 0.9
    only_position: bool = False
    max_kalman_prediction_without_update: int = 7
    matching_strategy: str = "strong_sort"
    w_kfgd: float = 1.0
    w_reid: float = 1.0
    w_st: float = 1.0
    gating_thres_factor: float = 1.0
    n_parts: int = 6
    embed_dim: int = 512
    n_keypoints: int = 17
    batched: bool = False
    emit_costs: bool = False
    max_tracks: int = 128
    max_dets: int = 64


class BPBReIDStrongSortState(NamedTuple):
    """Slot state of one video; with a leading video axis every field
    gains a first dimension V (next_id and frame become (V,))."""
    mean: torch.Tensor            # (T, 8)
    cov: torch.Tensor             # (T, 8, 8)
    feat: torch.Tensor            # (T, P, E) part features (EMA)
    vis: torch.Tensor             # (T, P) visibility scores
    kps: torch.Tensor             # (T, K, 3) last detection keypoints
    last_pred_ltrb: torch.Tensor  # (T, 4) KF box at the last match, NaN
    tstate: torch.Tensor          # before the first
    hits: torch.Tensor
    age: torch.Tensor
    time_since_update: torch.Tensor
    conf: torch.Tensor
    cls: torch.Tensor
    ref: torch.Tensor
    track_id: torch.Tensor
    active: torch.Tensor
    next_id: torch.Tensor
    frame: torch.Tensor


class BPBReIDStrongSortOutput(NamedTuple):
    """Per-frame emission, slot-indexed with a validity mask; the cost
    fields are None unless ``cfg.emit_costs``."""
    ltrb: torch.Tensor
    track_id: torch.Tensor
    cls: torch.Tensor
    conf: torch.Tensor
    ref: torch.Tensor
    hits: torch.Tensor
    age: torch.Tensor
    time_since_update: torch.Tensor
    pred_ltrb: torch.Tensor
    tstate: torch.Tensor
    valid: torch.Tensor
    costs_r: Optional[torch.Tensor] = None
    costs_s: Optional[torch.Tensor] = None
    costs_k: Optional[torch.Tensor] = None
    matched_stage: Optional[torch.Tensor] = None
    matched_cost: Optional[torch.Tensor] = None
    cost_track_valid: Optional[torch.Tensor] = None
    cost_track_id: Optional[torch.Tensor] = None


def bpbreid_init(cfg: BPBReIDStrongSortConfig, dtype=torch.float32,
                 device=None) -> BPBReIDStrongSortState:
    """Empty tracker state on ``device`` (``cuda`` unless told otherwise)."""
    dev = resolve_device(device)
    T, P, E, K = cfg.max_tracks, cfg.n_parts, cfg.embed_dim, cfg.n_keypoints
    f = partial(torch.zeros, dtype=dtype, device=dev)
    fi = partial(torch.zeros, dtype=torch.int32, device=dev)
    return BPBReIDStrongSortState(
        mean=f((T, 8)), cov=f((T, 8, 8)), feat=f((T, P, E)), vis=f((T, P)),
        kps=f((T, K, 3)),
        last_pred_ltrb=torch.full((T, 4), float("nan"), dtype=dtype,
                                  device=dev),
        tstate=fi(T), hits=fi(T), age=fi(T), time_since_update=fi(T),
        conf=f(T), cls=f(T),
        ref=torch.full((T,), -1, dtype=torch.int32, device=dev),
        track_id=fi(T), active=torch.zeros(T, dtype=torch.bool, device=dev),
        next_id=fi(()), frame=fi(()),
    )


def part_based_distance(trk_feat, trk_vis, det_feat, det_vis):
    """Part-weighted appearance distance (..., T, D): per part 1 - cos of
    the features (the squared Euclidean distance of unit features, halved),
    averaged with weights trk_vis * det_vis; 1.0 where the weight mass is
    empty. trk_feat (..., T, P, E), det_feat (..., D, P, E)."""
    eps = 1e-12
    tf = trk_feat / torch.clamp(torch.linalg.vector_norm(
        trk_feat, dim=-1, keepdim=True), min=eps)
    df = det_feat / torch.clamp(torch.linalg.vector_norm(
        det_feat, dim=-1, keepdim=True), min=eps)
    d = 1.0 - torch.einsum("...tpe,...dpe->...tpd", tf, df)
    w = trk_vis[..., None] * det_vis.transpose(-1, -2)[..., None, :, :]
    wsum = w.sum(dim=-2)
    out = (d * w).sum(dim=-2) / torch.clamp(wsum, min=eps)
    return torch.where(wsum > eps, out, torch.ones_like(out))


def bpbreid_step(cfg: BPBReIDStrongSortConfig, st: BPBReIDStrongSortState,
                 inputs):
    """One frame. ``inputs`` = (Detections, feat (D, P, E), vis (D, P), kps
    (D, K, 3), warp (2, 3)) for one video, or each with a leading video
    axis V for a state with one."""
    if inputs[0].ltrb.dim() == 2:
        return single_video(_step, cfg, st, inputs)
    return _step(cfg, st, inputs)


def _step(cfg: BPBReIDStrongSortConfig, st: BPBReIDStrongSortState, inputs):
    """:func:`bpbreid_step` over a leading video axis."""
    det, feat, vis, kps, warp = inputs
    T = cfg.max_tracks
    i32 = torch.int32
    st = st._replace(frame=st.frame + 1)
    act = st.active.to(i32)

    warped = _apply_warp(st.mean, warp)
    mean_in = torch.where(st.active[..., None], warped, st.mean)
    pred_mean, pred_cov = KF.predict(mean_in, st.cov)
    # KF-prediction freeze for long-coasting tracks (sort/track.py:128-136):
    # the state stops propagating; the track stays alive
    do_pred = st.active & (st.time_since_update
                           < cfg.max_kalman_prediction_without_update)
    st = st._replace(
        mean=torch.where(do_pred[..., None], pred_mean, mean_in),
        cov=torch.where(do_pred[..., None, None], pred_cov, st.cov),
        age=st.age + act, time_since_update=st.time_since_update + act)

    det_xyah = B.ltwh_to_xyah(B.ltrb_to_ltwh(det.ltrb))
    confirmed = st.active & (st.tstate == CONFIRMED)
    app = part_based_distance(st.feat, st.vis, feat, vis).transpose(-1, -2)
    gating = KF.gating_distance(st.mean, st.cov, det_xyah,
                                cfg.only_position).transpose(-1, -2)
    gthr = CHI2INV95_2D if cfg.only_position else CHI2INV95_4D

    def motion_cost_matrix():
        if cfg.motion_criterium == "oks":
            sim = oks_matrix(st.kps, kps).transpose(-1, -2)       # (V, D, T)
            sim = torch.where(torch.isfinite(sim), sim,
                              torch.zeros_like(sim))
            return 1.0 - sim, cfg.max_oks_distance
        iou = B.iou_matrix(det.ltrb, _mean_to_ltrb(st.mean))
        return 1.0 - iou, cfg.max_iou_distance

    # pre-birth snapshot for the instrumentation matrices
    cost_active, cost_tid = st.active, st.track_id + 1
    raw_motion = motion_cost_matrix()[0] if cfg.emit_costs else None

    if cfg.matching_strategy == "bot_sort":
        # one assignment over all tracks: weighted sum of sqrt-Mahalanobis,
        # part-ReID and spatio-temporal costs, OR-gated
        pos_cost = torch.sqrt(torch.clamp(gating, min=0.0)) / (
            gthr ** 0.5 * cfg.gating_thres_factor)
        st_cost, motion_max = motion_cost_matrix()
        wsum = cfg.w_kfgd + cfg.w_reid + cfg.w_st
        cost = (cfg.w_kfgd * pos_cost + cfg.w_reid * app
                + cfg.w_st * st_cost) / wsum
        gate = torch.zeros_like(cost, dtype=torch.bool)
        if cfg.w_kfgd > 0:
            gate = gate | (pos_cost > 1.0)
        if cfg.w_reid > 0:
            gate = gate | (app > cfg.max_dist)
        if cfg.w_st > 0:
            gate = gate | (st_cost > motion_max)
        cost = torch.where(gate, INFTY_COST, cost)
        d2t_a = _clamped_matching(cost, det.valid, st.active, cfg.max_dist,
                                  batched=cfg.batched)
        t2d_a = _invert(d2t_a, T)
        d2t_b = torch.full_like(d2t_a, -1)
        t2d_b = _invert(d2t_b, T)
        stage_a_cost, stage_b_cost = cost, None
    else:
        # stage A: part-based ReID on confirmed tracks, KF-gated
        app_g = torch.where(gating > gthr, INFTY_COST, app)
        app_g = cfg.mc_lambda * app_g + (1 - cfg.mc_lambda) * gating
        d2t_a = _clamped_matching(app_g, det.valid, confirmed, cfg.max_dist,
                                  batched=cfg.batched)
        t2d_a = _invert(d2t_a, T)

        # stage B: motion cost (IoU of the prediction / OKS of last kps)
        unconfirmed = st.active & (st.tstate == TENTATIVE)
        recent = confirmed & (t2d_a < 0) & (st.time_since_update == 1)
        cand = unconfirmed | recent
        u_det = det.valid & (d2t_a < 0)
        motion_cost, motion_max = motion_cost_matrix()
        ok = u_det[..., :, None] & cand[..., None, :]
        motion_cost = torch.where(ok, motion_cost, INFTY_COST)
        d2t_b = _clamped_matching(motion_cost, u_det, cand, motion_max,
                                  batched=cfg.batched)
        t2d_b = _invert(d2t_b, T)
        stage_a_cost, stage_b_cost = app_g, motion_cost

    trk2det = torch.where(t2d_a >= 0, t2d_a, t2d_b)
    matched = trk2det >= 0

    # matched updates: NSA KF, part EMA, lifecycle. The KF box is recorded
    # post-predict, pre-update (track.py:148 last_kf_pred_ltwh)
    pred_snapshot = _mean_to_ltrb(st.mean)
    safe = torch.where(matched, trk2det, 0)
    z = take_rows(det_xyah, safe)
    z_conf = take_rows(det.conf, safe)
    upd_mean, upd_cov = KF.update(st.mean, st.cov, z, z_conf)
    new_hits = st.hits + matched.to(i32)
    promote = matched & (st.tstate == TENTATIVE) & (new_hits >= cfg.n_init)

    # visibility-aware EMA (track.py:150-169)
    dfeat = take_rows(feat, safe)                       # (V, T, P, E)
    dvis = take_rows(vis, safe)                         # (V, T, P)
    both = st.vis * dvis
    xor = torch.logical_xor(st.vis > 0, dvis > 0).to(st.vis.dtype)
    w_trk = both * cfg.ema_alpha + xor * st.vis
    w_det = both * (1 - cfg.ema_alpha) + xor * dvis
    smooth = w_trk[..., None] * st.feat + w_det[..., None] * dfeat
    never = (w_trk == 0) & (w_det == 0)
    smooth = torch.where(never[..., None], torch.ones_like(smooth), smooth)
    new_vis = torch.maximum(st.vis, dvis)
    m1 = matched[..., None]
    st = st._replace(
        mean=torch.where(m1, upd_mean, st.mean),
        cov=torch.where(m1[..., None], upd_cov, st.cov),
        feat=torch.where(m1[..., None], smooth, st.feat),
        vis=torch.where(m1, new_vis, st.vis),
        kps=torch.where(m1[..., None], take_rows(kps, safe), st.kps),
        last_pred_ltrb=torch.where(m1, pred_snapshot, st.last_pred_ltrb),
        hits=new_hits,
        time_since_update=torch.where(matched, 0, st.time_since_update),
        tstate=torch.where(promote, CONFIRMED, st.tstate),
        conf=torch.where(matched, z_conf, st.conf),
        cls=torch.where(matched, take_rows(det.cls, safe), st.cls),
        ref=torch.where(matched, take_rows(det.ref, safe), st.ref),
    )

    # mark_missed
    unmatched_trk = st.active & ~matched
    kill = unmatched_trk & ((st.tstate == TENTATIVE)
                            | (st.time_since_update > cfg.max_age))
    st = st._replace(active=st.active & ~kill)

    # births, in detection order into free slots
    still = det.valid & (d2t_a < 0) & (d2t_b < 0)
    det2slot = claim_slots(~st.active, still)
    birth = det2slot >= 0

    def scat(arr, val):
        return birth_scatter(det2slot, birth, arr, val)

    dev = det.ltrb.device
    init_mean, init_cov = KF.initiate(det_xyah)
    birth_ids = (st.next_id[..., None]
                 + torch.cumsum(birth.to(i32), -1, dtype=i32) - 1)
    st = st._replace(
        mean=scat(st.mean, init_mean),
        cov=scat(st.cov, init_cov),
        feat=scat(st.feat, feat),
        vis=scat(st.vis, vis),
        kps=scat(st.kps, kps),
        last_pred_ltrb=scat(st.last_pred_ltrb, torch.full(
            (), float("nan"), dtype=st.last_pred_ltrb.dtype, device=dev)),
        tstate=scat(st.tstate, torch.full((), TENTATIVE, dtype=i32,
                                          device=dev)),
        hits=scat(st.hits, torch.ones((), dtype=i32, device=dev)),
        age=scat(st.age, torch.ones((), dtype=i32, device=dev)),
        time_since_update=scat(st.time_since_update,
                               torch.zeros((), dtype=i32, device=dev)),
        conf=scat(st.conf, det.conf),
        cls=scat(st.cls, det.cls),
        ref=scat(st.ref, det.ref),
        track_id=scat(st.track_id, birth_ids),
        active=scat(st.active, birth),
        next_id=st.next_id + birth.sum(dim=-1, dtype=i32),
    )

    # the reference emits only tracks updated at this frame
    # (strong_sort.py:96 'time_since_update > 0 -> skip')
    emit = (st.active & (st.tstate == CONFIRMED)
            & (st.time_since_update == 0))
    extras = {}
    if cfg.emit_costs:
        in_a, in_b = d2t_a >= 0, d2t_b >= 0
        stage = torch.where(in_a, 1, torch.where(in_b, 2, 0)).to(i32)
        ca = _take_cols(stage_a_cost, torch.where(in_a, d2t_a, 0).long())
        cb = (_take_cols(stage_b_cost, torch.where(in_b, d2t_b, 0).long())
              if stage_b_cost is not None else torch.zeros_like(ca))
        inf = torch.full_like(ca, float("inf"))
        extras = dict(
            costs_r=app, costs_s=raw_motion, costs_k=gating,
            matched_stage=stage,
            matched_cost=torch.where(in_a, ca, torch.where(in_b, cb, inf)),
            cost_track_valid=cost_active, cost_track_id=cost_tid)
    out = BPBReIDStrongSortOutput(
        ltrb=_mean_to_ltrb(st.mean), track_id=st.track_id + 1, cls=st.cls,
        conf=st.conf, ref=st.ref, hits=st.hits, age=st.age,
        time_since_update=st.time_since_update, pred_ltrb=st.last_pred_ltrb,
        tstate=st.tstate, valid=emit, **extras)
    return st, out


def _default_inputs(cfg, dets, kps, warps, lead):
    """Zero keypoints and identity warps where the caller gives none;
    ``lead`` is the leading (frame) or (video, frame) shape."""
    dt, dev = dets.ltrb.dtype, dets.ltrb.device
    if kps is None:
        kps = torch.zeros(dets.ltrb.shape[:-1] + (cfg.n_keypoints, 3),
                          dtype=dt, device=dev)
    if warps is None:
        warps = torch.eye(2, 3, dtype=dt, device=dev).expand(lead + (2, 3))
    return kps, warps


def bpbreid_scan(cfg: BPBReIDStrongSortConfig, dets: Detections, feat, vis,
                 kps=None, warps=None,
                 init: BPBReIDStrongSortState | None = None, resets=None):
    """Track one padded video. ``dets`` fields have a leading frame axis F;
    feat (F, D, P, E), vis (F, D, P), kps (F, D, K, 3) (zeros when None),
    warps (F, 2, 3) (identity when None); ``resets`` (F,) bool
    re-initializes the carry at marked frames. Returns (final_state,
    BPBReIDStrongSortOutput with a leading frame axis)."""
    F = dets.ltrb.shape[0]
    if init is None:
        init = bpbreid_init(cfg, dets.ltrb.dtype, dets.ltrb.device)
    kps, warps = _default_inputs(cfg, dets, kps, warps, (F,))
    step = partial(bpbreid_step, cfg)
    if resets is not None:
        step = reset_wrapped_step(step, init)
    st, outs = init, []
    for f in range(F):
        x = (Detections(*(a[f] for a in dets)), feat[f], vis[f], kps[f],
             warps[f])
        st, out = step(st, x if resets is None else (x, resets[f]))
        outs.append(out)
    return st, stack_frames(outs)


def bpbreid_scan_videos(cfg: BPBReIDStrongSortConfig, dets: Detections, feat,
                        vis, kps=None, warps=None):
    """Track V padded videos at once, one frame step for all of them: every
    input has leading (V, F) axes. Returns (final_state with a leading V
    axis, BPBReIDStrongSortOutput with leading (V, F) axes); each video's
    output equals its own :func:`bpbreid_scan`. The counterpart of
    ``jax.vmap(lambda *a: bpbreid_scan(cfg, *a))``."""
    V, F = dets.ltrb.shape[:2]
    kps, warps = _default_inputs(cfg, dets, kps, warps, (V, F))
    st = repeat_state(bpbreid_init(cfg, dets.ltrb.dtype, dets.ltrb.device),
                      V)
    outs = []
    for f in range(F):
        st, out = _step(cfg, st, (Detections(*(a[:, f] for a in dets)),
                                  feat[:, f], vis[:, f], kps[:, f],
                                  warps[:, f]))
        outs.append(out)
    return st, stack_frames(outs, dim=1)
