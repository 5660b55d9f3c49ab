"""Pose evaluation: OKS-similarity HOTA/MOTA/IDF1, keypoint mAP, per-joint
PCKh keypoint AP and box mAP (counterpart of tracklab_tpu.eval.pose_metrics,
kept as the port's own copy).

The core metrics do not depend on the similarity, so pose tracking reuses
``eval/metrics.py`` with an OKS similarity matrix in place of IoU; keypoint
detection quality is COCO-style AP over OKS thresholds.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from tracklab_torch.eval.metrics import SequenceData

__all__ = ["make_pose_sequence_data", "keypoint_map", "np_oks_matrix"]

# COCO kappa (the constants of ops/oks.py, a host copy)
KAPPA = np.array([
    0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
    0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089,
])


def _np_oks(gt_kp, pred_kps, kappa):
    """Reference-skeleton OKS (host numpy twin of ops/oks.py)."""
    visible = gt_kp[:, 2] > 0
    if not visible.any():
        return np.zeros(len(pred_kps))
    tl = gt_kp[visible, :2].min(0)
    br = gt_kp[visible, :2].max(0)
    area = (br[0] - tl[0]) * (br[1] - tl[1])
    ttl, tbr = gt_kp[:, :2].min(0), gt_kp[:, :2].max(0)
    total = (tbr[0] - ttl[0]) * (tbr[1] - ttl[1])
    c = s = np.sqrt(0.5)
    rot = np.array([[c, -s], [s, c]])
    r = gt_kp[:, :2] @ rot.T
    rv = r[visible]
    a45 = (rv[:, 0].max() - rv[:, 0].min()) * (rv[:, 1].max()
                                               - rv[:, 1].min())
    t45 = (r[:, 0].max() - r[:, 0].min()) * (r[:, 1].max()
                                             - r[:, 1].min())
    factor = np.sqrt(min(total / area if area > 0.1 else np.inf,
                         t45 / a45 if a45 > 0.1 else np.inf))
    scale = np.sqrt(max(area, 0)) * min(5.0, factor)
    if scale < 0.1 or not np.isfinite(scale):
        return np.zeros(len(pred_kps))
    d2 = ((gt_kp[None, :, 0] - pred_kps[:, :, 0]) ** 2
          + (gt_kp[None, :, 1] - pred_kps[:, :, 1]) ** 2)
    k = kappa[: gt_kp.shape[0]]
    per = np.exp(-d2 / (2 * scale ** 2 * k[None] ** 2)) \
        * visible[None].astype(float)
    return per.sum(1) / visible.sum()


def np_oks_matrix(gt_kps, pred_kps, kappa=None):
    """(G, K, 3) x (P, K, 3) -> (G, P) OKS similarity."""
    if kappa is None:
        kappa = KAPPA
    if len(gt_kps) == 0 or len(pred_kps) == 0:
        return np.zeros((len(gt_kps), len(pred_kps)))
    return np.stack([_np_oks(g, pred_kps, kappa) for g in gt_kps])


def make_pose_sequence_data(gt_frames: Dict[int, tuple],
                            pred_frames: Dict[int, tuple]) -> SequenceData:
    """Like metrics.make_sequence_data but with OKS similarity.
    Frames map to (ids, keypoints (N, K, 3))."""
    frames = sorted(set(gt_frames) | set(pred_frames))
    gt_id_map, pred_id_map = {}, {}
    gt_ids, pred_ids, sims = [], [], []
    n_gt = n_pred = 0
    for f in frames:
        gids, gkps = gt_frames.get(f, (np.zeros(0, int),
                                       np.zeros((0, 17, 3))))
        pids, pkps = pred_frames.get(f, (np.zeros(0, int),
                                         np.zeros((0, 17, 3))))
        for i in gids:
            gt_id_map.setdefault(i, len(gt_id_map))
        for i in pids:
            pred_id_map.setdefault(i, len(pred_id_map))
        gt_ids.append(np.array([gt_id_map[i] for i in gids], int))
        pred_ids.append(np.array([pred_id_map[i] for i in pids], int))
        sims.append(np_oks_matrix(np.asarray(gkps), np.asarray(pkps)))
        n_gt += len(gids)
        n_pred += len(pids)
    return SequenceData(len(gt_id_map), len(pred_id_map), n_gt, n_pred,
                        gt_ids, pred_ids, sims)


def keypoint_map(gt_frames, pred_frames, pred_scores,
                 thresholds=None) -> dict:
    """COCO-style keypoint AP over OKS thresholds.

    gt_frames / pred_frames: {frame: (N, K, 3) keypoints};
    pred_scores: {frame: (N,) confidence}.
    """
    if thresholds is None:
        thresholds = np.arange(0.5, 0.99, 0.05)
    all_matches = []   # (score, {thr: tp})
    n_gt = 0
    for f in sorted(set(gt_frames) | set(pred_frames)):
        g = np.asarray(gt_frames.get(f, np.zeros((0, 17, 3))))
        p = np.asarray(pred_frames.get(f, np.zeros((0, 17, 3))))
        s = np.asarray(pred_scores.get(f, np.zeros(len(p))))
        n_gt += len(g)
        if len(p) == 0:
            continue
        oks = np_oks_matrix(g, p) if len(g) else np.zeros((0, len(p)))
        order = np.argsort(-s)
        taken = {float(t): np.zeros(len(g), bool) for t in thresholds}
        for j in order:
            rec = {"score": float(s[j]), "tp": {}}
            for t in thresholds:
                t = float(t)
                best, best_g = 0.0, -1
                for gi in range(len(g)):
                    if taken[t][gi]:
                        continue
                    if oks[gi, j] > best:
                        best, best_g = oks[gi, j], gi
                if best >= t and best_g >= 0:
                    taken[t][best_g] = True
                    rec["tp"][t] = True
                else:
                    rec["tp"][t] = False
            all_matches.append(rec)
    if n_gt == 0 or not all_matches:
        return {"kp_mAP": 0.0, "kp_AP50": 0.0, "kp_AP75": 0.0}
    all_matches.sort(key=lambda r: -r["score"])
    aps = {}
    for t in thresholds:
        t = float(t)
        tp = np.array([r["tp"][t] for r in all_matches], float)
        fp = 1.0 - tp
        ctp, cfp = np.cumsum(tp), np.cumsum(fp)
        recall = ctp / n_gt
        precision = ctp / np.maximum(ctp + cfp, 1e-12)
        # 101-point interpolation
        ap = 0.0
        for r in np.linspace(0, 1, 101):
            mask = recall >= r
            ap += precision[mask].max() if mask.any() else 0.0
        aps[t] = ap / 101
    m = float(np.mean(list(aps.values())))
    return {"kp_mAP": m * 100,
            "kp_AP50": aps[min(aps, key=lambda k: abs(k - 0.5))] * 100,
            "kp_AP75": aps[min(aps, key=lambda k: abs(k - 0.75))] * 100}


def keypoint_ap_per_joint(gt_frames, pred_frames, pred_scores,
                          head_sizes, n_joints: int = 15,
                          joint_names=None) -> dict:
    """Per-joint keypoint average precision with PCKh matching.

    The per-joint breakdown the reference obtains from poseval's
    evaluateAP (tracklab/wrappers/eval/posetrack/
    posetrack21_evaluator.py:78-105, "Pose estimation - keypoints
    average precision"). poseval is not vendored in the reference, so
    this is a behavioral rebuild of its documented procedure: per frame,
    predicted poses are one-to-one assigned to GT poses by maximal PCKh
    (fraction of joints within 0.5 head sizes); per joint, a matched
    pose pair contributes a TP when that joint's head-normalized
    distance is <= 0.5 (FN otherwise if the GT joint is annotated), and
    every valid predicted joint not a TP is a FP; AP is 101-point
    interpolated over the pose-score ranking.

    gt_frames/pred_frames: {frame: (N, J, >=2)}; pred_scores:
    {frame: (N,)}; head_sizes: {frame: (N,)} aligned with gt.
    Returns {"per_joint_AP": (J,), "total_AP": float, "names": [...]}.
    """
    from scipy.optimize import linear_sum_assignment

    from tracklab_torch.eval.pose_reid_metrics import pckh_distance_matrix

    records = [[] for _ in range(n_joints)]  # (score, is_tp) per joint
    n_gt = np.zeros(n_joints, int)
    for f in sorted(set(gt_frames) | set(pred_frames)):
        g = np.asarray(gt_frames.get(f, np.zeros((0, n_joints, 2))),
                       float)
        p = np.asarray(pred_frames.get(f, np.zeros((0, n_joints, 2))),
                       float)
        s = np.asarray(pred_scores.get(f, np.ones(len(p))), float)
        hs = np.asarray(head_sizes.get(f, np.ones(len(g))), float)
        g_ok = (g[:, :, 0] > 0) & (g[:, :, 1] > 0) if len(g) \
            else np.zeros((0, n_joints), bool)
        p_ok = (p[:, :, 0] > 0) & (p[:, :, 1] > 0) if len(p) \
            else np.zeros((0, n_joints), bool)
        n_gt += g_ok.sum(0).astype(int)
        if len(p) == 0:
            continue
        if len(g) == 0:
            for j in range(n_joints):
                for i in np.nonzero(p_ok[:, j])[0]:
                    records[j].append((float(s[i]), False))
            continue
        dist = pckh_distance_matrix(g, p, hs)        # (N, M, J)
        match = dist <= 0.5
        pck = match.sum(-1).astype(float) \
            / np.maximum(g_ok.sum(-1), 1)[:, None]   # (N, M)
        rows, cols = linear_sum_assignment(-pck)
        pair_of_pred = np.full(len(p), -1, int)
        for r, c in zip(rows, cols):
            if pck[r, c] > 0:
                pair_of_pred[c] = r
        for j in range(n_joints):
            for i in range(len(p)):
                if not p_ok[i, j]:
                    continue
                r = pair_of_pred[i]
                tp = r >= 0 and bool(match[r, i, j]) and g_ok[r, j]
                records[j].append((float(s[i]), bool(tp)))
    aps = np.zeros(n_joints)
    for j in range(n_joints):
        if n_gt[j] == 0 or not records[j]:
            continue
        recs = sorted(records[j], key=lambda r: -r[0])
        tp = np.array([r[1] for r in recs], float)
        ctp, cfp = np.cumsum(tp), np.cumsum(1.0 - tp)
        recall = ctp / n_gt[j]
        precision = ctp / np.maximum(ctp + cfp, 1e-12)
        ap = 0.0
        for r in np.linspace(0, 1, 101):
            mask = recall >= r
            ap += precision[mask].max() if mask.any() else 0.0
        aps[j] = ap / 101
    return {"per_joint_AP": aps * 100,
            "total_AP": float(aps.mean() * 100),
            "names": list(joint_names) if joint_names else
            [f"joint_{j}" for j in range(n_joints)]}


def box_map(gt_frames, pred_frames, pred_scores,
            thresholds=None) -> dict:
    """COCO-style detection box mAP over IoU thresholds (the metric the
    reference gets from torchmetrics MeanAveragePrecision in its
    eval_mot branch, posetrack21_evaluator.py:193-201; torchmetrics is
    not a dependency, so this implements the COCO
    procedure: score-ranked greedy matching per threshold, 101-point
    interpolated AP, averaged over IoU 0.50:0.95).

    gt_frames/pred_frames: {frame: (N, 4) ltwh}; pred_scores:
    {frame: (N,)}.
    """
    if thresholds is None:
        thresholds = np.arange(0.5, 0.99, 0.05)
    from tracklab_torch.eval.metrics import _iou_ltwh

    records = []
    n_gt = 0
    for f in sorted(set(gt_frames) | set(pred_frames)):
        g = np.asarray(gt_frames.get(f, np.zeros((0, 4))), float)
        p = np.asarray(pred_frames.get(f, np.zeros((0, 4))), float)
        s = np.asarray(pred_scores.get(f, np.ones(len(p))), float)
        n_gt += len(g)
        if len(p) == 0:
            continue
        iou = _iou_ltwh(g, p) if len(g) else np.zeros((0, len(p)))
        order = np.argsort(-s)
        taken = {float(t): np.zeros(len(g), bool) for t in thresholds}
        for j in order:
            rec = {"score": float(s[j]), "tp": {}}
            for t in thresholds:
                t = float(t)
                best, best_g = t, -1
                for gi in range(len(g)):
                    if taken[t][gi]:
                        continue
                    if iou[gi, j] >= best:
                        best, best_g = iou[gi, j], gi
                if best_g >= 0:
                    taken[t][best_g] = True
                    rec["tp"][t] = True
                else:
                    rec["tp"][t] = False
            records.append(rec)
    if n_gt == 0 or not records:
        return {"bbox_mAP": 0.0, "bbox_AP50": 0.0, "bbox_AP75": 0.0}
    records.sort(key=lambda r: -r["score"])
    aps = {}
    for t in thresholds:
        t = float(t)
        tp = np.array([r["tp"][t] for r in records], float)
        ctp, cfp = np.cumsum(tp), np.cumsum(1.0 - tp)
        recall = ctp / n_gt
        precision = ctp / np.maximum(ctp + cfp, 1e-12)
        ap = 0.0
        for r in np.linspace(0, 1, 101):
            mask = recall >= r
            ap += precision[mask].max() if mask.any() else 0.0
        aps[t] = ap / 101
    return {"bbox_mAP": float(np.mean(list(aps.values()))) * 100,
            "bbox_AP50": aps[min(aps, key=lambda k: abs(k - 0.5))] * 100,
            "bbox_AP75": aps[min(aps, key=lambda k: abs(k - 0.75))] * 100}
