"""MOT evaluation metrics: HOTA, CLEAR (MOTA/MOTP) and Identity (IDF1)
(counterpart of tracklab_tpu.eval.metrics, kept as the port's own copy).

The TrackEval metric definitions in numpy on the host. Each frame's
assignment is ``scipy.optimize.linear_sum_assignment``, the solver
TrackEval itself uses (the JAX package takes a C++ LAPJV that falls back
to it). Every metric consumes a ``SequenceData``: per-frame ground-truth
and predicted id arrays and the per-frame GT x pred IoU matrix.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
from scipy.optimize import linear_sum_assignment

__all__ = ["SequenceData", "make_sequence_data", "hota_metrics",
           "clear_metrics", "identity_metrics", "evaluate_sequence",
           "combine_sequences"]

EPS = np.finfo(float).eps


@dataclass
class SequenceData:
    num_gt_ids: int
    num_pred_ids: int
    num_gt_dets: int
    num_pred_dets: int
    gt_ids: List[np.ndarray]          # per frame, contiguous 0-based ids
    pred_ids: List[np.ndarray]
    similarity: List[np.ndarray]      # per frame (n_gt_t, n_pred_t)


def _iou_ltwh(gt, pred):
    if len(gt) == 0 or len(pred) == 0:
        return np.zeros((len(gt), len(pred)))
    g = gt[:, None, :]
    p = pred[None, :, :]
    gx2, gy2 = g[..., 0] + g[..., 2], g[..., 1] + g[..., 3]
    px2, py2 = p[..., 0] + p[..., 2], p[..., 1] + p[..., 3]
    xx1 = np.maximum(g[..., 0], p[..., 0])
    yy1 = np.maximum(g[..., 1], p[..., 1])
    xx2 = np.minimum(gx2, px2)
    yy2 = np.minimum(gy2, py2)
    inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
    union = g[..., 2] * g[..., 3] + p[..., 2] * p[..., 3] - inter
    return np.where(union > 0, inter / np.maximum(union, EPS), 0.0)


def make_sequence_data(gt_frames: Dict[int, tuple],
                       pred_frames: Dict[int, tuple]) -> SequenceData:
    """Build SequenceData from {frame: (ids array, boxes ltwh array)}."""
    frames = sorted(set(gt_frames) | set(pred_frames))
    gt_id_map, pred_id_map = {}, {}
    gt_ids, pred_ids, sims = [], [], []
    n_gt = n_pred = 0
    for f in frames:
        gids, gboxes = gt_frames.get(f, (np.zeros(0, int),
                                         np.zeros((0, 4))))
        pids, pboxes = pred_frames.get(f, (np.zeros(0, int),
                                           np.zeros((0, 4))))
        for i in gids:
            if i not in gt_id_map:
                gt_id_map[i] = len(gt_id_map)
        for i in pids:
            if i not in pred_id_map:
                pred_id_map[i] = len(pred_id_map)
        gt_ids.append(np.array([gt_id_map[i] for i in gids], int))
        pred_ids.append(np.array([pred_id_map[i] for i in pids], int))
        sims.append(_iou_ltwh(np.asarray(gboxes, float).reshape(-1, 4),
                              np.asarray(pboxes, float).reshape(-1, 4)))
        n_gt += len(gids)
        n_pred += len(pids)
    return SequenceData(len(gt_id_map), len(pred_id_map), n_gt, n_pred,
                        gt_ids, pred_ids, sims)


# ---------------------------------------------------------------------------
# HOTA (TrackEval definition)
# ---------------------------------------------------------------------------

HOTA_ALPHAS = np.arange(0.05, 0.99, 0.05)


def hota_metrics(data: SequenceData) -> dict:
    A = len(HOTA_ALPHAS)
    res = {k: np.zeros(A) for k in
           ["HOTA_TP", "HOTA_FN", "HOTA_FP"]}
    if data.num_pred_dets == 0:
        res["HOTA_FN"] = np.full(A, float(data.num_gt_dets))
        res["LocA_sum"] = np.zeros(A)
        res["AssA_num"] = np.zeros(A)
        res["FragA_num"] = np.zeros(A)
        return _hota_finalize(res)
    if data.num_gt_dets == 0:
        res["HOTA_FP"] = np.full(A, float(data.num_pred_dets))
        res["LocA_sum"] = np.zeros(A)
        res["AssA_num"] = np.zeros(A)
        res["FragA_num"] = np.zeros(A)
        return _hota_finalize(res)

    potential = np.zeros((data.num_gt_ids, data.num_pred_ids))
    gt_count = np.zeros((data.num_gt_ids, 1))
    pred_count = np.zeros((1, data.num_pred_ids))
    for gids, pids, sim in zip(data.gt_ids, data.pred_ids, data.similarity):
        if len(gids) and len(pids):
            denom = (sim.sum(0)[None, :] + sim.sum(1)[:, None] - sim)
            sim_iou = np.zeros_like(sim)
            m = denom > EPS
            sim_iou[m] = sim[m] / denom[m]
            potential[gids[:, None], pids[None, :]] += sim_iou
        gt_count[gids] += 1
        pred_count[0, pids] += 1

    global_alignment = potential / np.maximum(
        gt_count + pred_count - potential, EPS)

    matches = [np.zeros((data.num_gt_ids, data.num_pred_ids))
               for _ in range(A)]
    loca_sum = np.zeros(A)
    # FragA bookkeeping (the PoseTrack21 fork of TrackEval): per alpha,
    # per gt, runs of consecutive matches to the same pred id; switching
    # away and back starts a new fragment for that (gt, pred) pair.
    last_matched = [{} for _ in range(A)]
    frag_sizes = [{} for _ in range(A)]
    for gids, pids, sim in zip(data.gt_ids, data.pred_ids, data.similarity):
        if len(gids) == 0:
            for a in range(A):
                res["HOTA_FP"][a] += len(pids)
            continue
        if len(pids) == 0:
            for a in range(A):
                res["HOTA_FN"][a] += len(gids)
            continue
        score = global_alignment[gids[:, None], pids[None, :]] * sim
        rows, cols = linear_sum_assignment(-score)
        for a, alpha in enumerate(HOTA_ALPHAS):
            ok = sim[rows, cols] >= alpha - EPS
            mr, mc = rows[ok], cols[ok]
            tp = len(mr)
            res["HOTA_TP"][a] += tp
            res["HOTA_FN"][a] += len(gids) - tp
            res["HOTA_FP"][a] += len(pids) - tp
            loca_sum[a] += sim[mr, mc].sum()
            matches[a][gids[mr], pids[mc]] += 1
            for g, p in zip(gids[mr].tolist(), pids[mc].tolist()):
                if last_matched[a].get(g) != p:
                    last_matched[a][g] = p
                    frag_sizes[a].setdefault((g, p), []).append(1)
                else:
                    frag_sizes[a][(g, p)][-1] += 1

    ass_num = np.zeros(A)
    frag_num = np.zeros(A)
    for a in range(A):
        m = matches[a]
        ass_a = m / np.maximum(gt_count + pred_count - m, EPS)
        ass_num[a] = (m * ass_a).sum()
        for (g, p), sizes in frag_sizes[a].items():
            denom = max(1.0, float(gt_count[g, 0] + pred_count[0, p]
                                   - m[g, p]))
            frag_num[a] += sum(sz * sz for sz in sizes) / denom
    res["LocA_sum"] = loca_sum
    res["AssA_num"] = ass_num
    res["FragA_num"] = frag_num
    return _hota_finalize(res)


def _hota_finalize(res: dict) -> dict:
    tp, fn, fp = res["HOTA_TP"], res["HOTA_FN"], res["HOTA_FP"]
    det_a = tp / np.maximum(tp + fn + fp, EPS)
    ass_a = res["AssA_num"] / np.maximum(tp, EPS)
    frag_a = res.get("FragA_num", np.zeros_like(tp)) / np.maximum(tp, EPS)
    hota = np.sqrt(det_a * ass_a)
    loca = res["LocA_sum"] / np.maximum(tp, EPS)
    out = dict(res)
    out.update({
        "DetA_alpha": det_a, "AssA_alpha": ass_a, "HOTA_alpha": hota,
        "HOTA": float(hota.mean() * 100),
        "DetA": float(det_a.mean() * 100),
        "AssA": float(ass_a.mean() * 100),
        "LocA": float(np.maximum(loca, EPS).mean() * 100),
        "FragA": float(frag_a.mean() * 100),
        "HOTA(0)": float(hota[0] * 100),
    })
    return out


# ---------------------------------------------------------------------------
# CLEAR / MOTA (py-motmetrics event-model semantics)
# ---------------------------------------------------------------------------

def clear_metrics(data: SequenceData, threshold: float = 0.5) -> dict:
    tp = fn = fp = idsw = 0
    motp_sum = 0.0
    frag = 0
    prev_match = np.full(data.num_gt_ids, -1)        # last matched pred id
    gt_tracked_prev = np.zeros(data.num_gt_ids, bool)
    gt_seen = np.zeros(data.num_gt_ids, bool)
    gt_frames = np.zeros(data.num_gt_ids, int)       # presence count
    gt_matched_frames = np.zeros(data.num_gt_ids, int)

    for gids, pids, sim in zip(data.gt_ids, data.pred_ids, data.similarity):
        if len(gids):
            np.add.at(gt_frames, gids, 1)
        if len(gids) == 0:
            fp += len(pids)
            gt_tracked_prev = np.zeros(data.num_gt_ids, bool)
            continue
        if len(pids) == 0:
            fn += len(gids)
            gt_tracked_prev = np.zeros(data.num_gt_ids, bool)
            continue
        score = np.where(sim >= threshold - EPS, sim, 0.0)
        # carry-over bonus: prefer continuing the previous match
        bonus = np.zeros_like(score)
        for i, g in enumerate(gids):
            if prev_match[g] >= 0:
                js = np.nonzero(pids == prev_match[g])[0]
                if len(js):
                    bonus[i, js[0]] = 1000.0
        score_b = np.where(score > 0, score + bonus, 0.0)
        rows, cols = linear_sum_assignment(-score_b)
        ok = score[rows, cols] > 0
        mr, mc = rows[ok], cols[ok]
        tp += len(mr)
        fn += len(gids) - len(mr)
        fp += len(pids) - len(mr)
        motp_sum += sim[mr, mc].sum()
        gt_tracked_now = np.zeros(data.num_gt_ids, bool)
        for i, j in zip(mr, mc):
            g, p = gids[i], pids[j]
            if prev_match[g] >= 0 and prev_match[g] != p:
                idsw += 1
            if gt_seen[g] and not gt_tracked_prev[g] and prev_match[g] >= 0:
                frag += 1
            prev_match[g] = p
            gt_seen[g] = True
            gt_tracked_now[g] = True
            gt_matched_frames[g] += 1
        gt_tracked_prev = gt_tracked_now

    num_gt = data.num_gt_dets
    mota = 1.0 - (fn + fp + idsw) / max(num_gt, 1)
    motp = motp_sum / max(tp, 1)
    # trajectory coverage (TrackEval MT/PT/ML: >=80% / 20-80% / <20%)
    present = gt_frames > 0
    ratio = gt_matched_frames[present] / np.maximum(
        gt_frames[present], 1)
    mt = int(np.sum(ratio >= 0.8))
    ml = int(np.sum(ratio < 0.2))
    pt = int(present.sum()) - mt - ml
    return {
        "CLR_TP": tp, "CLR_FN": fn, "CLR_FP": fp, "IDSW": idsw,
        "Frag": frag, "MOTP_sum": motp_sum, "CLR_gt": num_gt,
        "MOTA": float(mota * 100), "MOTP": float(motp * 100),
        "CLR_Re": float(tp / max(num_gt, 1) * 100),
        "CLR_Pr": float(tp / max(tp + fp, 1) * 100),
        "MT": mt, "PT": pt, "ML": ml,
    }


# ---------------------------------------------------------------------------
# Identity / IDF1 (global min-cost id mapping)
# ---------------------------------------------------------------------------

def identity_metrics(data: SequenceData, threshold: float = 0.5) -> dict:
    n_g, n_p = data.num_gt_ids, data.num_pred_ids
    match_counts = np.zeros((n_g, n_p))
    gt_counts = np.zeros(n_g)
    pred_counts = np.zeros(n_p)
    for gids, pids, sim in zip(data.gt_ids, data.pred_ids, data.similarity):
        if len(gids):
            np.add.at(gt_counts, gids, 1)
        if len(pids):
            np.add.at(pred_counts, pids, 1)
        if len(gids) and len(pids):
            ok = sim >= threshold - EPS
            match_counts[gids[:, None], pids[None, :]] += ok

    # padded square cost: matching a (gt, pred) pair costs its FN+FP,
    # leaving an id unmatched costs all its detections
    BIG = gt_counts.sum() + pred_counts.sum() + 1.0
    size = n_g + n_p
    cost = np.zeros((size, size))
    cost[:n_g, :n_p] = (gt_counts[:, None] + pred_counts[None, :]
                        - 2 * match_counts)
    cost[:n_g, n_p:] = BIG
    cost[n_g:, :n_p] = BIG
    for i in range(n_g):
        cost[i, n_p + i] = gt_counts[i]
    for j in range(n_p):
        cost[n_g + j, j] = pred_counts[j]
    rows, cols = linear_sum_assignment(cost)
    idtp = 0.0
    for r, c in zip(rows, cols):
        if r < n_g and c < n_p:
            idtp += match_counts[r, c]
    idfn = gt_counts.sum() - idtp
    idfp = pred_counts.sum() - idtp
    idf1 = 2 * idtp / max(2 * idtp + idfn + idfp, 1)
    return {
        "IDTP": idtp, "IDFN": idfn, "IDFP": idfp,
        "IDF1": float(idf1 * 100),
        "IDR": float(idtp / max(idtp + idfn, 1) * 100),
        "IDP": float(idtp / max(idtp + idfp, 1) * 100),
    }


# ---------------------------------------------------------------------------

def count_metrics(data: SequenceData) -> dict:
    """TrackEval's Count metric family."""
    return {
        "Dets": int(data.num_pred_dets),
        "GT_Dets": int(data.num_gt_dets),
        "IDs": int(data.num_pred_ids),
        "GT_IDs": int(data.num_gt_ids),
        "Frames": len(data.gt_ids),
    }


def evaluate_sequence(data: SequenceData) -> dict:
    out = {}
    out.update(hota_metrics(data))
    out.update(clear_metrics(data))
    out.update(identity_metrics(data))
    out.update(count_metrics(data))
    return out


def combine_sequences(per_seq: Dict[str, dict]) -> dict:
    """Combine per-sequence results by summing the count fields and
    re-deriving the final metrics (TrackEval combine_sequences)."""
    A = len(HOTA_ALPHAS)
    agg = {k: np.zeros(A) for k in
           ["HOTA_TP", "HOTA_FN", "HOTA_FP", "AssA_num", "LocA_sum",
            "FragA_num"]}
    counts = {k: 0.0 for k in
              ["CLR_TP", "CLR_FN", "CLR_FP", "IDSW", "Frag", "MOTP_sum",
               "CLR_gt", "IDTP", "IDFN", "IDFP", "MT", "PT", "ML",
               "Dets", "GT_Dets", "IDs", "GT_IDs", "Frames"]}
    for res in per_seq.values():
        for k in agg:
            agg[k] = agg[k] + res[k]
        for k in counts:
            counts[k] += res[k]
    out = _hota_finalize(agg)
    tp, fn, fp = counts["CLR_TP"], counts["CLR_FN"], counts["CLR_FP"]
    idsw = counts["IDSW"]
    num_gt = counts["CLR_gt"]
    out.update({
        "CLR_TP": tp, "CLR_FN": fn, "CLR_FP": fp, "IDSW": idsw,
        "Frag": counts["Frag"],
        "MT": counts["MT"], "PT": counts["PT"], "ML": counts["ML"],
        "MOTA": float((1 - (fn + fp + idsw) / max(num_gt, 1)) * 100),
        "MOTP": float(counts["MOTP_sum"] / max(tp, 1) * 100),
        "CLR_Re": float(tp / max(num_gt, 1) * 100),
        "CLR_Pr": float(tp / max(tp + fp, 1) * 100),
    })
    idtp = counts["IDTP"]
    out.update({
        "IDTP": idtp, "IDFN": counts["IDFN"], "IDFP": counts["IDFP"],
        "IDF1": float(2 * idtp / max(2 * idtp + counts["IDFN"]
                                     + counts["IDFP"], 1) * 100),
    })
    out.update({k: int(counts[k]) for k in
                ["Dets", "GT_Dets", "IDs", "GT_IDs", "Frames"]})
    return out
