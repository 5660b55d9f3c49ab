"""Deep-OC-SORT as a per-frame step on tensors (counterpart of
tracklab_tpu.trackers.deepocsort).

OC-SORT's motion machinery plus appearance, step for step as the JAX
package (the reference deep_oc_sort/ocsort.py:96-535 and
association.py:263-364):

  * the "new KF": 8-dim [x, y, w, h, v*] with process noise Q(w, h) and
    measurement noise R(w, h), Joseph-form updates, negative-size guards
    and frozen-velocity zeroing at predict;
  * stage-1 cost -(IoU + velocity direction + adaptively weighted
    embedding similarity), then OCR on the last observations;
  * a confidence-adaptive EMA of the track embeddings;
  * camera motion compensation: per-frame 2x3 warps applied to the filter
    state, the frozen ORU snapshot, the last observation and the
    observation ring.

The ORU replay interpolates the xywh measurements directly, as the JAX
package does (its documented deviation from the reference). On the card it
is one kernel launch (``kernels/oru_replay.py:oru_replay_nkf``), each slot
to its own gap.

One implementation steps V videos at once over a leading video axis (state
fields (V, T, ...), detections (V, D, ...)); on one video's tensors the
axis is added and dropped again. The JAX package's ``lax.cond`` branches
become device-side selections, and each association stage is one solve
launch for all V videos: K1 in the default mode, K2 with ``cfg.batched``.
A step issues no host sync.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import torch

from tracklab_torch.device import resolve_device
from tracklab_torch.kernels.oru_replay import oru_replay_nkf
from tracklab_torch.ops import boxes as B
from tracklab_torch.ops.assignment import greedy_unique_match, matching_forced
from tracklab_torch.ops.embeddings import normalize_rows
from tracklab_torch.ops.kalman import _diag, _inv4, _shift4_predict
from tracklab_torch.trackers.common import (Detections, birth_scatter,
                                            claim_slots, invert_match,
                                            kron_eye4, repeat_state,
                                            scan_inputs, scan_video_inputs,
                                            single_video, take_rows)
from tracklab_torch.trackers.ocsort import (_k_previous_obs, _post_filter,
                                            _recovery_match,
                                            _speed_direction_cost)

__all__ = ["DeepOCSortConfig", "DeepOCSortState", "DeepOCSortOutput",
           "deepocsort_init", "deepocsort_step", "deepocsort_scan",
           "deepocsort_scan_videos"]


# ---------------------------------------------------------------------------
# the "new KF": xywh with dynamic noise (ocsort.py:82-93, 116-145), over any
# leading (video, slot) dims; F = I + E and H = [I4 | 0] act as slices
# ---------------------------------------------------------------------------

_WP, _WV = 1.0 / 20, 1.0 / 160


def _nkf_Q(w, h):
    """Process noise: diag of (wp w, wp h, wp w, wp h, wv w, ...)**2."""
    return _diag(torch.stack([_WP * w, _WP * h, _WP * w, _WP * h,
                              _WV * w, _WV * h, _WV * w, _WV * h], dim=-1))


def _nkf_R(w, h):
    """Measurement noise, as its diagonal (wp w, wp h, wp w, wp h)**2."""
    wv = (_WP * w) * (_WP * w)
    hv = (_WP * h) * (_WP * h)
    return torch.stack([wv, hv, wv, hv], dim=-1)


def _nkf_initiate(z):
    """Measurement (..., 4) xywh -> x (..., 8), P = Q(w, h) with the
    position block x4 and the velocity block x100."""
    x = torch.cat([z, torch.zeros_like(z)], dim=-1)
    q = torch.diagonal(_nkf_Q(z[..., 2], z[..., 3]), dim1=-2, dim2=-1)
    return x, torch.diag_embed(torch.cat([q[..., :4] * 4.0,
                                          q[..., 4:] * 100.0], dim=-1))


def _nkf_predict(x, P, frozen):
    """Zero a size velocity that would turn its size non-positive, zero
    both where ``frozen`` (..., bool), then x' = F x, P' = F P F' + Q(w, h)
    with Q from the pre-shift size."""
    vw = torch.where(x[..., 2] + x[..., 6] <= 0, 0.0, x[..., 6])
    vh = torch.where(x[..., 3] + x[..., 7] <= 0, 0.0, x[..., 7])
    vw = torch.where(frozen, 0.0, vw)
    vh = torch.where(frozen, 0.0, vh)
    x = torch.cat([x[..., :6], vw[..., None], vh[..., None]], dim=-1)
    return _shift4_predict(x, P, _nkf_Q(x[..., 2], x[..., 3]))


def _nkf_update(x, P, z):
    """Joseph-form update with R from the prior state's size: H = [I4 | 0]
    and R diagonal, so S = P[:4, :4] + R inverts in closed form."""
    r = _nkf_R(x[..., 2], x[..., 3])
    y = z - x[..., :4]
    S = P[..., :4, :4] + torch.diag_embed(r)
    K = P[..., :, :4] @ _inv4(S)
    x_new = x + (K @ y[..., None])[..., 0]
    A = P - K @ P[..., :4, :]
    Kt = K.transpose(-1, -2)
    return x_new, A - A[..., :, :4] @ Kt + (K * r[..., None, :]) @ Kt


# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DeepOCSortConfig:
    """Defaults mirror tracklab's configs/modules/track/deep_oc_sort.yaml.
    ``angle_cost_scale="category"`` keeps the reference's class-column
    scale of the velocity cost (as OC-SORT's). ``batched=True`` is the
    cond-free multi-video mode (K2)."""
    det_thresh: float = 0.0
    max_age: int = 50
    min_hits: int = 1
    iou_threshold: float = 0.2214
    delta_t: int = 1
    asso_func: str = "giou"
    inertia: float = 0.3942
    w_association_emb: float = 0.75
    alpha_fixed_emb: float = 0.95
    aw_param: float = 0.5
    embedding_off: bool = False
    aw_off: bool = False
    angle_cost_scale: str = "category"
    embed_dim: int = 512
    batched: bool = False
    max_tracks: int = 128
    max_dets: int = 64


class DeepOCSortState(NamedTuple):
    """Slot state of one video; with a leading video axis every field
    gains a first dimension V (next_id and frame_count become (V,))."""
    kf_x: torch.Tensor          # (T, 8)
    kf_P: torch.Tensor          # (T, 8, 8)
    frozen_x: torch.Tensor      # (T, 8) ORU snapshot
    frozen_P: torch.Tensor      # (T, 8, 8)
    frozen_z: torch.Tensor      # (T, 4) last real measurement (xywh)
    observed: torch.Tensor      # (T,) bool
    has_frozen: torch.Tensor    # (T,) bool
    emb: torch.Tensor           # (T, E) normalised track embedding
    last_obs: torch.Tensor      # (T, 5) ltrb + conf
    has_obs: torch.Tensor       # (T,) bool
    last_obs_age: torch.Tensor  # (T,) int32
    obs_ring: torch.Tensor      # (T, delta_t + 1, 5)
    ring_age: torch.Tensor      # (T, delta_t + 1) int32, -1 when empty
    velocity: torch.Tensor      # (T, 2) (dy, dx)
    age: torch.Tensor
    time_since_update: torch.Tensor
    hits: torch.Tensor
    hit_streak: torch.Tensor
    track_id: torch.Tensor      # (T,) int32, 0-based; emitted + 1
    cls: torch.Tensor
    conf: torch.Tensor
    ref: torch.Tensor
    active: torch.Tensor
    next_id: torch.Tensor       # () int32
    frame_count: torch.Tensor   # () int32


class DeepOCSortOutput(NamedTuple):
    """Per-frame emission, slot-indexed with a validity mask."""
    ltrb: torch.Tensor
    track_id: torch.Tensor
    cls: torch.Tensor
    conf: torch.Tensor
    ref: torch.Tensor
    valid: torch.Tensor


def deepocsort_init(cfg: DeepOCSortConfig, dtype=torch.float32,
                    device=None) -> DeepOCSortState:
    """Empty tracker state on ``device`` (``cuda`` unless told otherwise)."""
    dev = resolve_device(device)
    T, K, E = cfg.max_tracks, cfg.delta_t + 1, cfg.embed_dim
    f = partial(torch.full, dtype=dtype, device=dev)
    fi = partial(torch.full, dtype=torch.int32, device=dev)
    fb = partial(torch.zeros, dtype=torch.bool, device=dev)
    return DeepOCSortState(
        kf_x=f((T, 8), 0.0), kf_P=f((T, 8, 8), 0.0),
        frozen_x=f((T, 8), 0.0), frozen_P=f((T, 8, 8), 0.0),
        frozen_z=f((T, 4), 0.0), observed=fb(T), has_frozen=fb(T),
        emb=f((T, E), 0.0),
        last_obs=f((T, 5), -1.0), has_obs=fb(T), last_obs_age=fi((T,), 0),
        obs_ring=f((T, K, 5), -1.0), ring_age=fi((T, K), -1),
        velocity=f((T, 2), 0.0),
        age=fi((T,), 0), time_since_update=fi((T,), 0), hits=fi((T,), 0),
        hit_streak=fi((T,), 0), track_id=fi((T,), 0),
        cls=f((T,), 0.0), conf=f((T,), 0.0), ref=fi((T,), -1),
        active=fb(T), next_id=fi((), 0), frame_count=fi((), 0))


def _aw_weight(emb_cost, valid, w_emb: float, bottom: float):
    """compute_aw_max_metric (association.py:263-289) with capacity
    masking, over (V, D, T): per row and per column, a weight from the
    ratio of the two largest valid entries; rows or columns with fewer
    than two valid entries keep the base weight."""
    masked = torch.where(valid, emb_cost, -1e9)

    def axis_weight(m, n_valid):
        top2 = torch.topk(m, 2, dim=-1).values      # only values are used
        first, second = top2[..., 0], top2[..., 1]
        ratio = torch.where(first != 0, second / first, 0.0)
        weight = 1.0 - torch.clamp(ratio - bottom, min=0.0) / (1.0 - bottom)
        weight = torch.where(first == 0, 0.0, weight)
        return torch.where(n_valid < 2, 1.0, weight)

    row_w = axis_weight(masked, valid.sum(dim=-1))                 # (V, D)
    col_w = axis_weight(masked.transpose(-1, -2), valid.sum(dim=-2))
    w = w_emb * row_w[..., :, None] * col_w[..., None, :]
    return w * emb_cost


def _affine(p, warp):
    """Points p (V, ..., 2) through per-video 2x3 warps (V, 2, 3):
    ``p @ m.T + t``."""
    n, V = p.dim() - 2, warp.shape[0]
    mt = warp[:, :, :2].transpose(-1, -2).reshape((V,) + (1,) * (n - 1)
                                                  + (2, 2))
    return p @ mt + warp[:, :, 2].reshape((V,) + (1,) * n + (2,))


def _warp_boxes5(boxes5, warp, mask):
    """Warp ltrb + conf rows (V, ..., 5) where ``mask`` (ocsort.py:255-270)."""
    warped = torch.cat([_affine(boxes5[..., 0:2], warp),
                        _affine(boxes5[..., 2:4], warp), boxes5[..., 4:5]],
                       dim=-1)
    return torch.where(mask[..., None], warped, boxes5)


def deepocsort_step(cfg: DeepOCSortConfig, st: DeepOCSortState, inputs):
    """One frame. ``inputs`` = (Detections, emb (D, E), warp (2, 3)) for
    one video, or each with a leading video axis V for a state with one."""
    if inputs[0].ltrb.dim() == 2:
        return single_video(_step, cfg, st, inputs)
    return _step(cfg, st, inputs)


def _step(cfg: DeepOCSortConfig, st: DeepOCSortState, inputs):
    """:func:`deepocsort_step` over a leading video axis."""
    det, emb, warp = inputs
    T = cfg.max_tracks
    V, D = det.ltrb.shape[:2]
    dev = det.ltrb.device
    dt = st.kf_x.dtype
    i32 = torch.int32
    st = st._replace(frame_count=st.frame_count + 1)

    keep = det.valid & (det.conf > cfg.det_thresh)
    emb_n = torch.where(
        torch.linalg.vector_norm(emb, dim=-1, keepdim=True) > 1e-6,
        normalize_rows(emb), torch.zeros_like(emb))
    # detection EMA alphas (ocsort.py:414-419)
    trust = (det.conf - cfg.det_thresh) / (1.0 - cfg.det_thresh)
    af = cfg.alpha_fixed_emb
    det_alpha = af + (1 - af) * (1 - trust)

    # CMC on the state, the frozen snapshot and the observations
    m2, tvec = warp[:, :, :2], warp[:, :, 2]
    big = kron_eye4(m2)
    big_t = big.transpose(-1, -2)[:, None]

    def warp_x(x):
        x = x @ big_t[:, 0]
        return torch.cat([x[..., 0:2] + tvec[:, None], x[..., 2:]], dim=-1)

    def warp_P(P):
        return big[:, None] @ P @ big_t

    fro_z = torch.cat([_affine(st.frozen_z[..., 0:2], warp),
                       st.frozen_z[..., 2:4] @ m2.transpose(-1, -2)], dim=-1)
    act = st.active
    fro = act & st.has_frozen
    st = st._replace(
        kf_x=torch.where(act[..., None], warp_x(st.kf_x), st.kf_x),
        kf_P=torch.where(act[..., None, None], warp_P(st.kf_P), st.kf_P),
        frozen_x=torch.where(fro[..., None], warp_x(st.frozen_x),
                             st.frozen_x),
        frozen_P=torch.where(fro[..., None, None], warp_P(st.frozen_P),
                             st.frozen_P),
        frozen_z=torch.where(fro[..., None], fro_z, st.frozen_z),
        last_obs=_warp_boxes5(st.last_obs, warp, act & st.has_obs),
        obs_ring=_warp_boxes5(st.obs_ring, warp,
                              act[..., None] & (st.ring_age >= 0)))

    # predict (frozen tracks get their velocities zeroed)
    pred_x, pred_P = _nkf_predict(st.kf_x, st.kf_P, ~st.observed & st.has_obs)
    pred_x = torch.where(st.active[..., None], pred_x, st.kf_x)
    pred_P = torch.where(st.active[..., None, None], pred_P, st.kf_P)
    trk_ltrb = B.xywh_to_ltrb(pred_x[..., :4])
    active = st.active & torch.isfinite(trk_ltrb).all(dim=-1)
    a_i = active.to(i32)
    st = st._replace(
        kf_x=pred_x, kf_P=pred_P, active=active, age=st.age + a_i,
        hit_streak=torch.where(st.time_since_update > 0, 0, st.hit_streak),
        time_since_update=st.time_since_update + a_i)

    # stage 1: IoU + velocity direction + weighted appearance
    k_obs = _k_previous_obs(st, cfg)
    pair_ok = keep[..., :, None] & st.active[..., None, :]
    iou = torch.where(pair_ok, B.iou_matrix(det.ltrb, trk_ltrb), 0.0)
    angle_scale = det.cls if cfg.angle_cost_scale == "category" else det.conf
    angle = _speed_direction_cost(det.ltrb, angle_scale, keep, k_obs,
                                  st.velocity, st.active, cfg.inertia)
    if cfg.embedding_off:
        emb_term = torch.zeros_like(iou)
    else:
        emb_sim = emb_n @ st.emb.transpose(-1, -2)              # (V, D, T)
        emb_sim = torch.where(iou <= 0, 0.0, emb_sim)
        emb_sim = torch.where(pair_ok, emb_sim, 0.0)
        emb_term = (emb_sim * cfg.w_association_emb if cfg.aw_off else
                    _aw_weight(emb_sim, pair_ok, cfg.w_association_emb,
                               cfg.aw_param))
    cost = -(iou + angle + emb_term)
    if cfg.batched:
        det2trk = matching_forced(cost, keep, st.active, batched=True)
    else:
        is_unique, greedy = greedy_unique_match(iou, keep, st.active,
                                                cfg.iou_threshold)
        solved = matching_forced(cost, keep, st.active, need=~is_unique)
        det2trk = torch.where(is_unique[:, None], greedy, solved)
    det2trk = _post_filter(det2trk, iou, cfg.iou_threshold)
    trk_matched_1 = invert_match(det2trk, T) >= 0

    # OCR stage: asso_func on the last observations, gated per video
    u_det = keep & (det2trk < 0)
    u_trk = st.active & ~trk_matched_1
    ocr_d2t = _recovery_match(cfg, det.ltrb, u_det, st.last_obs[..., :4],
                              u_trk & st.has_obs)
    combined = torch.where(det2trk >= 0, det2trk, ocr_d2t)
    trk2det = torch.where(st.active, invert_match(combined, T), -1)
    matched = trk2det >= 0

    # freeze snapshots of tracks going unobserved
    unmatched_trk = st.active & ~matched
    freeze_now = unmatched_trk & st.observed
    st = st._replace(
        frozen_x=torch.where(freeze_now[..., None], st.kf_x, st.frozen_x),
        frozen_P=torch.where(freeze_now[..., None, None], st.kf_P,
                             st.frozen_P),
        has_frozen=st.has_frozen | freeze_now,
        observed=st.observed & ~unmatched_trk)

    # matched updates: ORU replay, KF update, embedding EMA, bookkeeping
    safe_t = torch.where(matched, trk2det, 0)
    z_ltrb = take_rows(det.ltrb, safe_t)
    z = B.ltrb_to_xywh(z_ltrb)
    need_oru = matched & st.active & ~st.observed & st.has_frozen
    gap = torch.clamp(st.age - st.last_obs_age, min=1)
    rep_x, rep_P = oru_replay_nkf(st.frozen_x, st.frozen_P, st.frozen_z, z,
                                  gap, need_oru)
    base_x = torch.where(need_oru[..., None], rep_x, st.kf_x)
    base_P = torch.where(need_oru[..., None, None], rep_P, st.kf_P)
    upd_x, upd_P = _nkf_update(base_x, base_P, z)

    # velocity from the delta_t-past observation
    k_obs_u = _k_previous_obs(st, cfg)
    prev_box = torch.where((k_obs_u[..., 4] >= 0)[..., None],
                           k_obs_u[..., :4], st.last_obs[..., :4])
    pcx = (prev_box[..., 0] + prev_box[..., 2]) * 0.5
    pcy = (prev_box[..., 1] + prev_box[..., 3]) * 0.5
    ncx = (z_ltrb[..., 0] + z_ltrb[..., 2]) * 0.5
    ncy = (z_ltrb[..., 1] + z_ltrb[..., 3]) * 0.5
    d = torch.stack([ncy - pcy, ncx - pcx], dim=-1)
    speed = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-6)
    set_vel = matched & st.has_obs

    # embedding EMA with the matched detection's alpha (update_emb)
    alpha_t = take_rows(det_alpha, safe_t)[..., None]
    emb_t = take_rows(emb_n, safe_t)
    new_emb = normalize_rows(alpha_t * st.emb + (1 - alpha_t) * emb_t)
    has_new_emb = matched & (torch.linalg.vector_norm(emb_t, dim=-1) > 1e-6)

    obs5 = torch.cat([z_ltrb, take_rows(det.conf, safe_t)[..., None]], dim=-1)
    K = cfg.delta_t + 1
    write = (torch.arange(K, dtype=i32, device=dev)
             == torch.remainder(st.age, K)[..., None]) & matched[..., None]
    m_i = matched.to(i32)
    st = st._replace(
        kf_x=torch.where(matched[..., None], upd_x, st.kf_x),
        kf_P=torch.where(matched[..., None, None], upd_P, st.kf_P),
        frozen_z=torch.where(matched[..., None], z, st.frozen_z),
        observed=st.observed | matched,
        emb=torch.where(has_new_emb[..., None], new_emb, st.emb),
        last_obs=torch.where(matched[..., None], obs5, st.last_obs),
        has_obs=st.has_obs | matched,
        last_obs_age=torch.where(matched, st.age, st.last_obs_age),
        obs_ring=torch.where(write[..., None], obs5[..., None, :],
                             st.obs_ring),
        ring_age=torch.where(write, st.age[..., None], st.ring_age),
        velocity=torch.where(set_vel[..., None], speed, st.velocity),
        time_since_update=torch.where(matched, 0, st.time_since_update),
        hits=st.hits + m_i, hit_streak=st.hit_streak + m_i,
        cls=torch.where(matched, take_rows(det.cls, safe_t), st.cls),
        # the reference sets conf only at birth (deep_oc_sort/ocsort.py:114)
        ref=torch.where(matched, take_rows(det.ref, safe_t), st.ref))

    # births: unmatched kept detections claim free slots
    det2slot = claim_slots(~st.active, keep & (combined < 0))
    birth = det2slot >= 0

    def scat(arr, val):
        return birth_scatter(det2slot, birth, arr, val)

    z_all = B.ltrb_to_xywh(det.ltrb)
    init_x, init_P = _nkf_initiate(z_all)
    birth_ids = (st.next_id[:, None]
                 + torch.cumsum(birth.to(i32), 1, dtype=i32) - 1)
    zf = torch.zeros((), dtype=dt, device=dev)
    zi = torch.zeros((), dtype=i32, device=dev)
    zb = torch.zeros((), dtype=torch.bool, device=dev)
    st = st._replace(
        kf_x=scat(st.kf_x, init_x), kf_P=scat(st.kf_P, init_P),
        frozen_x=scat(st.frozen_x, zf), frozen_P=scat(st.frozen_P, zf),
        frozen_z=scat(st.frozen_z, z_all),
        observed=scat(st.observed, zb), has_frozen=scat(st.has_frozen, zb),
        emb=scat(st.emb, emb_n),
        last_obs=scat(st.last_obs, zf - 1.0), has_obs=scat(st.has_obs, zb),
        last_obs_age=scat(st.last_obs_age, zi),
        obs_ring=scat(st.obs_ring, zf - 1.0),
        ring_age=scat(st.ring_age, zi - 1),
        velocity=scat(st.velocity, zf), age=scat(st.age, zi),
        time_since_update=scat(st.time_since_update, zi),
        hits=scat(st.hits, zi), hit_streak=scat(st.hit_streak, zi),
        track_id=scat(st.track_id, birth_ids), cls=scat(st.cls, det.cls),
        conf=scat(st.conf, det.conf), ref=scat(st.ref, det.ref),
        active=scat(st.active, birth),
        next_id=st.next_id + birth.sum(dim=1, dtype=i32))

    # emit every track updated this frame: the reference's update() never
    # advances frame_count, so its min_hits test always passes
    emit = st.active & (st.time_since_update < 1)
    out_box = torch.where(st.has_obs[..., None], st.last_obs[..., :4],
                          B.xywh_to_ltrb(st.kf_x[..., :4]))
    out = DeepOCSortOutput(ltrb=out_box, track_id=st.track_id + 1,
                           cls=st.cls, conf=st.conf, ref=st.ref, valid=emit)
    st = st._replace(active=st.active
                     & (st.time_since_update <= cfg.max_age))
    return st, out


def deepocsort_scan(cfg: DeepOCSortConfig, dets: Detections, emb,
                    warps=None, init: DeepOCSortState | None = None,
                    resets=None):
    """Track one padded video: ``dets`` fields and ``emb`` (F, D, E) have a
    leading frame axis F, ``warps`` (F, 2, 3) (identity when None);
    ``resets`` (F,) bool re-initialises the carry at marked frames. Returns
    (final_state, DeepOCSortOutput with a leading frame axis)."""
    if init is None:
        init = deepocsort_init(cfg, dets.ltrb.dtype, dets.ltrb.device)
    return scan_inputs(partial(deepocsort_step, cfg), init, dets, emb, warps,
                       resets)


def deepocsort_scan_videos(cfg: DeepOCSortConfig, dets: Detections, emb,
                           warps=None):
    """Track V padded videos at once, one frame step for all of them:
    every input has leading (V, F) axes. Each video's output equals its own
    :func:`deepocsort_scan`; the counterpart of ``jax.vmap`` of the JAX
    scan."""
    init = repeat_state(deepocsort_init(cfg, dets.ltrb.dtype,
                                        dets.ltrb.device), dets.ltrb.shape[0])
    return scan_video_inputs(partial(_step, cfg), init, dets, emb, warps)
