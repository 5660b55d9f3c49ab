"""StrongSORT as a per-frame step on tensors (counterpart of
tracklab_tpu.trackers.strongsort), and the helpers BPBReID-StrongSORT
shares with it.

Fixed-capacity slot state, step for step as the JAX package (the reference
strong_sort.py:18-85, sort/tracker.py:151-187, sort/track.py,
sort/nn_matching.py, sort/linear_assignment.py):

  * appearance stage: confirmed tracks x detections, the min-over-gallery
    cosine distance, Mahalanobis-gated (chi2 0.95, 4 dof) and blended with
    the gating distance (mc_lambda), clamped at max_dist and solved as a
    forced assignment (min_cost_matching's "cost > max -> max + 1e-5");
  * IoU stage: tentative tracks and appearance-unmatched confirmed tracks
    with time_since_update == 1 against the remaining detections;
  * the NSA Kalman filter, the feature EMA, a per-track gallery ring of
    ``nn_budget`` samples fed every frame by the confirmed tracks, and
    Tentative -> Confirmed after ``n_init`` hits;
  * optional per-frame 2x3 camera warps applied to the means before the
    predict (track.py:229-244).

One implementation steps V videos at once over a leading video axis (state
fields (V, T, ...), detections (V, D, ...)); on one video's tensors the
axis is added and dropped again. Each association stage is one solve
launch for all V videos: K1 in the default mode, K2 with ``cfg.batched``.
A step issues no host sync.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import torch

from tracklab_torch.device import resolve_device
from tracklab_torch.ops import boxes as B
from tracklab_torch.ops.assignment import min_cost_matching
from tracklab_torch.ops.embeddings import (ema_update, gallery_push,
                                           nn_gallery_distance,
                                           normalize_rows)
from tracklab_torch.ops.kalman import CHI2INV95_4D
from tracklab_torch.ops.kalman import XYAHNSAFilter as KF
from tracklab_torch.trackers.common import (Detections, birth_scatter,
                                            claim_slots, invert_match,
                                            repeat_state, scan_inputs,
                                            scan_video_inputs, single_video,
                                            take_rows)

__all__ = ["StrongSortConfig", "StrongSortState", "StrongSortOutput",
           "strongsort_init", "strongsort_step", "strongsort_scan",
           "strongsort_scan_videos", "_mean_to_ltrb", "_clamped_matching",
           "_invert", "_apply_warp"]

TENTATIVE = 1
CONFIRMED = 2
INFTY_COST = 1e5


@dataclass(frozen=True)
class StrongSortConfig:
    """Defaults mirror tracklab's configs/modules/track/strong_sort.yaml.
    ``batched=True`` is the cond-free multi-video mode (K2). The two modes
    agree except where free slots or padded detections give NaN gating
    costs: the default mode's column permutation spreads such a NaN over
    its row, which then goes unmatched (the reference's behaviour, kept
    for parity), so on real traffic the modes can part."""
    max_dist: float = 0.1594
    max_iou_dist: float = 0.5432
    max_age: int = 40
    n_init: int = 3
    nn_budget: int = 100
    mc_lambda: float = 0.995
    ema_alpha: float = 0.8962
    embed_dim: int = 512
    batched: bool = False
    max_tracks: int = 128
    max_dets: int = 64


class StrongSortState(NamedTuple):
    """Slot state of one video; with a leading video axis every field
    gains a first dimension V (next_id and frame become (V,))."""
    mean: torch.Tensor            # (T, 8)
    cov: torch.Tensor             # (T, 8, 8)
    feat: torch.Tensor            # (T, E) EMA-smoothed, normalised
    gallery: torch.Tensor         # (T, B, E)
    gallery_valid: torch.Tensor   # (T, B) bool
    gallery_pos: torch.Tensor     # (T,) int32 ring write position
    tstate: torch.Tensor          # (T,) int32 TENTATIVE/CONFIRMED
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


class StrongSortOutput(NamedTuple):
    """Per-frame emission, slot-indexed with a validity mask."""
    ltrb: torch.Tensor
    track_id: torch.Tensor
    cls: torch.Tensor
    conf: torch.Tensor
    ref: torch.Tensor
    valid: torch.Tensor


def strongsort_init(cfg: StrongSortConfig, dtype=torch.float32,
                    device=None) -> StrongSortState:
    """Empty tracker state on ``device`` (``cuda`` unless told otherwise)."""
    dev = resolve_device(device)
    T, Bq, E = cfg.max_tracks, cfg.nn_budget, cfg.embed_dim
    f = partial(torch.zeros, dtype=dtype, device=dev)
    fi = partial(torch.zeros, dtype=torch.int32, device=dev)
    return StrongSortState(
        mean=f((T, 8)), cov=f((T, 8, 8)), feat=f((T, E)),
        gallery=f((T, Bq, E)),
        gallery_valid=torch.zeros((T, Bq), dtype=torch.bool, device=dev),
        gallery_pos=fi(T), tstate=fi(T), hits=fi(T), age=fi(T),
        time_since_update=fi(T), conf=f(T), cls=f(T),
        ref=torch.full((T,), -1, dtype=torch.int32, device=dev),
        track_id=fi(T), active=torch.zeros(T, dtype=torch.bool, device=dev),
        next_id=fi(()), frame=fi(()))


def _mean_to_ltrb(mean):
    """xyah KF mean (..., 8) -> ltrb (..., 4)."""
    cx, cy, a, h = mean[..., 0], mean[..., 1], mean[..., 2], mean[..., 3]
    w = a * h
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def _clamped_matching(cost, row_mask, col_mask, max_distance, batched=False):
    """min_cost_matching semantics (linear_assignment.py:55-73) with the
    exact unique-candidate fast path; ``batched=True`` is the cond-free
    form."""
    return min_cost_matching(cost, row_mask, col_mask, max_distance,
                             batched=batched)


def _invert(det2trk, T: int):
    """det -> track map (V, D) to track -> det map (V, T), -1 where free."""
    return invert_match(det2trk, T)


def _apply_warp(mean, warp):
    """Apply a 2x3 affine camera warp per video to track means (V, T, 8)
    (track.py:221-244 camera_update): warp the box corners, refit xyah;
    velocities untouched."""
    ltrb = _mean_to_ltrb(mean)
    one = torch.ones_like(ltrb[..., 0])
    wt = warp.transpose(-1, -2)[..., None, :, :]            # (V, 1, 3, 2)
    p1 = (torch.stack([ltrb[..., 0], ltrb[..., 1], one], dim=-1)[..., None, :]
          @ wt)[..., 0, :]
    p2 = (torch.stack([ltrb[..., 2], ltrb[..., 3], one], dim=-1)[..., None, :]
          @ wt)[..., 0, :]
    w = p2[..., 0] - p1[..., 0]
    h = p2[..., 1] - p1[..., 1]
    cx = p1[..., 0] + w / 2
    cy = p1[..., 1] + h / 2
    a = w / torch.clamp(h, min=1e-6)
    new_pos = torch.stack([cx, cy, a, h], dim=-1)
    return torch.cat([new_pos, mean[..., 4:]], dim=-1)


def strongsort_step(cfg: StrongSortConfig, st: StrongSortState, inputs):
    """One frame. ``inputs`` = (Detections, emb (D, E), warp (2, 3)) for
    one video, or each with a leading video axis V for a state with one."""
    if inputs[0].ltrb.dim() == 2:
        return single_video(_step, cfg, st, inputs)
    return _step(cfg, st, inputs)


def _step(cfg: StrongSortConfig, st: StrongSortState, inputs):
    """:func:`strongsort_step` over a leading video axis."""
    det, emb, warp = inputs
    T = cfg.max_tracks
    i32 = torch.int32
    st = st._replace(frame=st.frame + 1)
    act = st.active.to(i32)

    # camera compensation + KF predict (tracker.predict)
    warped = _apply_warp(st.mean, warp)
    mean_in = torch.where(st.active[..., None], warped, st.mean)
    pred_mean, pred_cov = KF.predict(mean_in, st.cov)
    st = st._replace(
        mean=torch.where(st.active[..., None], pred_mean, st.mean),
        cov=torch.where(st.active[..., None, None], pred_cov, st.cov),
        age=st.age + act, time_since_update=st.time_since_update + act)

    det_xyah = B.ltwh_to_xyah(B.ltrb_to_ltwh(det.ltrb))     # (V, D, 4)
    emb_n = normalize_rows(emb)

    # stage A: appearance on confirmed tracks, costs (V, D, T)
    confirmed = st.active & (st.tstate == CONFIRMED)
    app = nn_gallery_distance(st.gallery, st.gallery_valid,
                              emb_n).transpose(-1, -2)
    gating = KF.gating_distance(st.mean, st.cov,
                                det_xyah).transpose(-1, -2)
    app = torch.where(gating > CHI2INV95_4D, INFTY_COST, app)
    app = cfg.mc_lambda * app + (1 - cfg.mc_lambda) * gating
    d2t_a = _clamped_matching(app, det.valid, confirmed, cfg.max_dist,
                              batched=cfg.batched)
    t2d_a = _invert(d2t_a, T)

    # stage B: IoU (tracker.py:173-183)
    unconfirmed = st.active & (st.tstate == TENTATIVE)
    recent = confirmed & (t2d_a < 0) & (st.time_since_update == 1)
    cand = unconfirmed | recent
    iou = B.iou_matrix(det.ltrb, _mean_to_ltrb(st.mean))
    ok = det.valid[..., :, None] & cand[..., None, :]
    iou_cost = torch.where(ok, 1.0 - iou, INFTY_COST)
    u_det = det.valid & (d2t_a < 0)
    d2t_b = _clamped_matching(iou_cost, u_det, cand, cfg.max_iou_dist,
                              batched=cfg.batched)
    t2d_b = _invert(d2t_b, T)

    trk2det = torch.where(t2d_a >= 0, t2d_a, t2d_b)
    matched = trk2det >= 0

    # matched updates: NSA KF, feature EMA, lifecycle
    safe = torch.where(matched, trk2det, 0)
    z_conf = take_rows(det.conf, safe)
    upd_mean, upd_cov = KF.update(st.mean, st.cov, take_rows(det_xyah, safe),
                                  z_conf)
    new_hits = st.hits + matched.to(i32)
    promote = matched & (st.tstate == TENTATIVE) & (new_hits >= cfg.n_init)
    st = st._replace(
        mean=torch.where(matched[..., None], upd_mean, st.mean),
        cov=torch.where(matched[..., None, None], upd_cov, st.cov),
        feat=ema_update(st.feat, take_rows(emb_n, safe), cfg.ema_alpha,
                        matched),
        hits=new_hits,
        time_since_update=torch.where(matched, 0, st.time_since_update),
        tstate=torch.where(promote, CONFIRMED, st.tstate),
        conf=torch.where(matched, z_conf, st.conf),
        cls=torch.where(matched, take_rows(det.cls, safe), st.cls),
        ref=torch.where(matched, take_rows(det.ref, safe), st.ref))

    # mark_missed (track.py:303-308)
    kill = st.active & ~matched & ((st.tstate == TENTATIVE)
                                   | (st.time_since_update > cfg.max_age))
    st = st._replace(active=st.active & ~kill)

    # births (tracker._initiate_track), in detection order into free slots
    still = det.valid & (d2t_a < 0) & (d2t_b < 0)
    det2slot = claim_slots(~st.active, still)
    birth = det2slot >= 0

    def scat(arr, val):
        return birth_scatter(det2slot, birth, arr, val)

    dev = det.ltrb.device
    born = scat(torch.zeros_like(st.active), torch.ones((), dtype=torch.bool,
                                                        device=dev))
    init_mean, init_cov = KF.initiate(det_xyah)
    birth_ids = (st.next_id[..., None]
                 + torch.cumsum(birth.to(i32), -1, dtype=i32) - 1)
    st = st._replace(
        mean=scat(st.mean, init_mean),
        cov=scat(st.cov, init_cov),
        feat=scat(st.feat, emb_n),
        # a newborn slot's gallery starts empty (the scatter of zeros)
        gallery=st.gallery.masked_fill(born[..., None, None], 0.0),
        gallery_valid=st.gallery_valid & ~born[..., None],
        gallery_pos=torch.where(born, 0, st.gallery_pos),
        tstate=torch.where(born, TENTATIVE, st.tstate),
        hits=torch.where(born, 1, st.hits),
        age=torch.where(born, 1, st.age),
        time_since_update=torch.where(born, 0, st.time_since_update),
        conf=scat(st.conf, det.conf),
        cls=scat(st.cls, det.cls),
        ref=scat(st.ref, det.ref),
        track_id=scat(st.track_id, birth_ids),
        active=st.active | born,
        next_id=st.next_id + birth.sum(dim=-1, dtype=i32))

    # gallery partial_fit (tracker.py:108-117): every confirmed track pushes
    # its smoothed feature each frame
    push = st.active & (st.tstate == CONFIRMED)
    gallery, gallery_valid, gallery_pos = gallery_push(
        st.gallery, st.gallery_valid, st.gallery_pos, st.feat, push)
    st = st._replace(gallery=gallery, gallery_valid=gallery_valid,
                     gallery_pos=gallery_pos)

    # emit (strong_sort.py:70-85): confirmed and updated within one frame
    emit = (st.active & (st.tstate == CONFIRMED)
            & (st.time_since_update <= 1))
    out = StrongSortOutput(ltrb=_mean_to_ltrb(st.mean),
                           track_id=st.track_id + 1, cls=st.cls,
                           conf=st.conf, ref=st.ref, valid=emit)
    return st, out


def strongsort_scan(cfg: StrongSortConfig, dets: Detections, emb,
                    warps=None, init: StrongSortState | None = None,
                    resets=None):
    """Track one padded video: ``dets`` fields and ``emb`` (F, D, E) have a
    leading frame axis F, ``warps`` (F, 2, 3) (identity when None);
    ``resets`` (F,) bool re-initialises the carry at marked frames. Returns
    (final_state, StrongSortOutput with a leading frame axis)."""
    if init is None:
        init = strongsort_init(cfg, dets.ltrb.dtype, dets.ltrb.device)
    return scan_inputs(partial(strongsort_step, cfg), init, dets, emb, warps,
                       resets)


def strongsort_scan_videos(cfg: StrongSortConfig, dets: Detections, emb,
                           warps=None):
    """Track V padded videos at once, one frame step for all of them:
    every input has leading (V, F) axes. Returns (final_state with a
    leading V axis, StrongSortOutput with leading (V, F) axes); each
    video's output equals its own :func:`strongsort_scan`. The counterpart
    of ``jax.vmap(lambda *a: strongsort_scan(cfg, *a))``."""
    init = repeat_state(strongsort_init(cfg, dets.ltrb.dtype,
                                        dets.ltrb.device), dets.ltrb.shape[0])
    return scan_video_inputs(partial(_step, cfg), init, dets, emb, warps)
