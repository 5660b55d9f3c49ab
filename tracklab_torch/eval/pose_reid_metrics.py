"""Cross-video (re-identification) keypoint HOTA and per-joint keypoint
MOTA (counterpart of tracklab_tpu.eval.pose_reid_metrics, kept as the
port's own copy).

The PoseTrack21 fork's reid evaluation (hota_pose_reid.py and
eval_reid.py): per-joint HOTA where ground-truth ids are dataset-global
person ids and predicted ids are pooled across all sequences, so
association credit needs the same person re-identified across videos.
Per-joint localisation is the head-normalised (PCKh) L2 distance mapped to
a similarity; matching maximises the TP count, then the similarity; the
association and fragmentation statistics accumulate over all sequences.

The fork's quirks are kept, as the JAX package keeps them:
  * a frame with no ground truth (no prediction) adds the SEQUENCE's total
    predicted (ground-truth) joint counts to FP (FN), not the frame's
    (hota_pose_reid.py:142-150);
  * the unique matching ignores the global alignment score and uses
    ``(sim >= alpha)/EPS + sim`` (TP count first, similarity second).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

__all__ = ["pckh_distance_matrix", "reid_keypoint_hota",
           "relabel_global_ids", "REID_ALPHAS"]

EPS = 1 / 1000
REID_ALPHAS = np.arange(0.05, 0.99, 0.05)


def pckh_distance_matrix(gt_kps: np.ndarray, pr_kps: np.ndarray,
                         head_sizes: np.ndarray) -> np.ndarray:
    """(N, J, >=2) gt, (M, J, >=2) pred, (N,) gt head sizes ->
    (N, M, J) head-normalized L2 distances; inf where either joint is
    invalid (coordinate <= 0), matching the fork's PCKh convention
    (datasets/posetrack.py:566-595)."""
    N, J = gt_kps.shape[:2]
    M = pr_kps.shape[0]
    dist = np.full((N, M, J), np.inf)
    if N == 0 or M == 0:
        return dist
    g_ok = (gt_kps[:, :, 0] > 0) & (gt_kps[:, :, 1] > 0)       # (N, J)
    p_ok = (pr_kps[:, :, 0] > 0) & (pr_kps[:, :, 1] > 0)       # (M, J)
    d = np.linalg.norm(gt_kps[:, None, :, :2] - pr_kps[None, :, :, :2],
                       axis=-1)                                 # (N, M, J)
    d = d / np.maximum(head_sizes, 1e-12)[:, None, None]
    ok = g_ok[:, None, :] & p_ok[None, :, :]
    dist[ok] = d[ok]
    return dist


def _as_kps(kps, n: int, n_joints: int) -> np.ndarray:
    """(n, J, C) float keypoints of a frame's n poses, (0, J, 2) for none.
    The JAX package reshapes with ``-1``, which numpy cannot infer for an
    empty array, so its metrics raise on a frame with ground truth and no
    prediction, or the reverse (ROADMAP §3); the port scores such a frame,
    by the quirk's rule above where it applies."""
    a = np.asarray(kps, float)
    return a.reshape(n, n_joints, -1) if a.size else np.zeros(
        (n, n_joints, 2))


def _dist2sim(dist: np.ndarray) -> np.ndarray:
    """head-normalized distance -> similarity: a PCKh match (dist <=
    0.5) maps linearly onto (0, 1] (hota_pose_reid.py:33-40)."""
    return np.maximum((-1 / 0.5001) * dist + 1, 0)


def relabel_global_ids(sequences):
    """Map raw (possibly sparse, per-dataset) gt/pred ids to dense
    global indices pooled over ALL sequences (eval_reid.py:174-220).
    sequences: {name: [(gt_ids, gt_kps, head_sizes, pr_ids, pr_kps)]}.
    Returns (relabeled sequences, num_gt_ids, num_pr_ids)."""
    all_gt, all_pr = [], []
    for frames in sequences.values():
        for gt_ids, _, _, pr_ids, _ in frames:
            all_gt.extend(np.asarray(gt_ids, int).tolist())
            all_pr.extend(np.asarray(pr_ids, int).tolist())
    gt_u = np.unique(all_gt) if all_gt else np.empty(0, int)
    pr_u = np.unique(all_pr) if all_pr else np.empty(0, int)
    gt_map = {int(v): i for i, v in enumerate(gt_u)}
    pr_map = {int(v): i for i, v in enumerate(pr_u)}
    out = {}
    for name, frames in sequences.items():
        out[name] = [
            (np.array([gt_map[int(i)] for i in gt_ids], int), gt_kps,
             head_sizes,
             np.array([pr_map[int(i)] for i in pr_ids], int), pr_kps)
            for gt_ids, gt_kps, head_sizes, pr_ids, pr_kps in frames]
    return out, len(gt_u), len(pr_u)


def reid_keypoint_hota(sequences: Dict[str, List[Tuple]],
                       num_gt_ids: int, num_pr_ids: int,
                       n_joints: int = 15,
                       alphas: Sequence[float] = REID_ALPHAS) -> dict:
    """Cross-video per-joint keypoint HOTA (hota_pose_reid.py
    eval_sequences). ids must already be dense GLOBAL indices
    (relabel_global_ids). Each frame: (gt_ids, gt_kps (N, J, >=2),
    head_sizes (N,), pr_ids, pr_kps (M, J, >=2)).

    Returns per-joint arrays of shape (len(alphas), n_joints + 1) — the
    final column is the joint average (float fields) / sum (counts) —
    plus the scalar summary fields.
    """
    alphas = np.asarray(alphas)
    A = len(alphas)
    res = {f: np.zeros((A, n_joints)) for f in
           ("HOTA_TP", "HOTA_FN", "HOTA_FP", "LocA", "AssA", "AssRe",
            "AssPr", "FragA")}

    pot = np.zeros((A, num_gt_ids, num_pr_ids, n_joints))
    gt_cnt = np.zeros((num_gt_ids, 1, n_joints))
    pr_cnt = np.zeros((1, num_pr_ids, n_joints))
    matches_cnt = np.zeros((A, num_gt_ids, num_pr_ids, n_joints))
    last_matched = np.full((A, num_gt_ids, n_joints), -1, int)
    # per (a, gid, pid, j): list of per-fragment TP counts
    fragments: dict = {}

    # precompute per-sequence per-frame similarities and totals; a
    # sequence with zero gt or zero pred detections contributes ONLY the
    # FN/FP quirk below — no id-count/potential-match accumulation
    # (hota_pose_reid.py:88-101 continues before pass 1)
    prepared = {}
    for name, frames in sequences.items():
        sims, totals_gt, totals_pr = [], np.zeros(n_joints, int), \
            np.zeros(n_joints, int)
        any_gt = any(len(f[0]) > 0 for f in frames)
        any_pr = any(len(f[3]) > 0 for f in frames)
        for gt_ids, gt_kps, head_sizes, pr_ids, pr_kps in frames:
            gt_kps = _as_kps(gt_kps, len(gt_ids), n_joints)
            pr_kps = _as_kps(pr_kps, len(pr_ids), n_joints)
            g_ok = (gt_kps[:, :, 0] > 0) & (gt_kps[:, :, 1] > 0)
            p_ok = (pr_kps[:, :, 0] > 0) & (pr_kps[:, :, 1] > 0)
            totals_gt += g_ok.sum(0).astype(int)
            totals_pr += p_ok.sum(0).astype(int)
            if not (any_gt and any_pr):
                continue
            sims.append(_dist2sim(pckh_distance_matrix(
                gt_kps, pr_kps, np.asarray(head_sizes, float))))
            # global det counts (accumulate across sequences)
            if len(gt_ids):
                np.add.at(gt_cnt, (np.asarray(gt_ids, int), 0), g_ok)
            if len(pr_ids):
                np.add.at(pr_cnt, (0, np.asarray(pr_ids, int)), p_ok)
        prepared[name] = (sims, totals_gt, totals_pr, any_gt, any_pr)

    # pass 1: potential matches per alpha (hota_pose_reid.py:104-121)
    for name, frames in sequences.items():
        sims, _, _, any_gt, any_pr = prepared[name]
        if not (any_gt and any_pr):
            continue
        for (gt_ids, _, _, pr_ids, _), sim in zip(frames, sims):
            if len(gt_ids) == 0 or len(pr_ids) == 0:
                continue
            gi = np.asarray(gt_ids, int)
            pi = np.asarray(pr_ids, int)
            for a, alpha in enumerate(alphas):
                rows, cols, js = np.nonzero(sim >= alpha)
                np.add.at(pot, (a, gi[rows], pi[cols], js), 1)

    # pass 2: unique matching per frame/joint/alpha
    for name, frames in sequences.items():
        sims, totals_gt, totals_pr, any_gt, any_pr = prepared[name]
        if not any_pr:
            # fork quirk: sequence contributes all gt joints as FN once
            res["HOTA_FN"] += totals_gt[None, :].astype(float)
            res["LocA"] += 1.0
            continue
        if not any_gt:
            res["HOTA_FP"] += totals_pr[None, :].astype(float)
            res["LocA"] += 1.0
            continue
        for (gt_ids, gt_kps, _, pr_ids, pr_kps), sim in zip(frames, sims):
            gi = np.asarray(gt_ids, int)
            pi = np.asarray(pr_ids, int)
            gt_kps = _as_kps(gt_kps, len(gi), n_joints)
            pr_kps = _as_kps(pr_kps, len(pi), n_joints)
            ngt_t = ((gt_kps[:, :, 0] > 0)
                     & (gt_kps[:, :, 1] > 0)).sum(0)
            npr_t = ((pr_kps[:, :, 0] > 0)
                     & (pr_kps[:, :, 1] > 0)).sum(0)
            if len(gi) == 0:
                # fork quirk: adds the SEQUENCE total, not npr_t
                res["HOTA_FP"] += totals_pr[None, :].astype(float)
                continue
            if len(pi) == 0:
                res["HOTA_FN"] += totals_gt[None, :].astype(float)
                continue
            for j in range(n_joints):
                sim_j = sim[:, :, j]
                for a, alpha in enumerate(alphas):
                    ms = (sim_j >= alpha).astype(float) / EPS + sim_j
                    rows, cols = linear_sum_assignment(ms, maximize=True)
                    ok = sim_j[rows, cols] >= alpha - np.finfo(float).eps
                    mr, mc = rows[ok], cols[ok]
                    nm = len(mr)
                    res["HOTA_TP"][a, j] += nm
                    res["HOTA_FN"][a, j] += ngt_t[j] - nm
                    res["HOTA_FP"][a, j] += npr_t[j] - nm
                    if nm == 0:
                        continue
                    res["LocA"][a, j] += sim_j[mr, mc].sum()
                    mg, mp = gi[mr], pi[mc]
                    np.add.at(matches_cnt, (a, mg, mp, j), 1)
                    # fragmentation bookkeeping (per gt, per joint):
                    # a fragment starts when the matched pred id changes
                    frag_new = last_matched[a, mg, j] != mp
                    last_matched[a, mg[frag_new], j] = mp[frag_new]
                    for g, p, new in zip(mg, mp, frag_new):
                        key = (a, g, p, j)
                        lst = fragments.setdefault(key, [])
                        if new or not lst:
                            lst.append(0)
                        lst[-1] += 1

    # global association + fragmentation scores (hota_pose_reid.py:220-250)
    for a in range(A):
        mc = matches_cnt[a]
        tpa = np.maximum(1, gt_cnt + pr_cnt - mc)
        res["AssA"][a] = (mc * (mc / tpa)).sum((0, 1)) \
            / np.maximum(1, res["HOTA_TP"][a])
        res["AssRe"][a] = (mc * (mc / np.maximum(1, gt_cnt))).sum((0, 1)) \
            / np.maximum(1, res["HOTA_TP"][a])
        res["AssPr"][a] = (mc * (mc / np.maximum(1, pr_cnt))).sum((0, 1)) \
            / np.maximum(1, res["HOTA_TP"][a])
        frag = np.zeros(n_joints)
        for (aa, g, p, j), lst in fragments.items():
            if aa != a:
                continue
            arr = np.asarray(lst, float)
            frag[j] += (arr ** 2).sum() / tpa[g, p, j]
        res["FragA"][a] = frag / np.maximum(1, res["HOTA_TP"][a])

    res["LocA"] = np.maximum(1e-10, res["LocA"]) \
        / np.maximum(1e-10, res["HOTA_TP"])
    # final fields (hota_pose_reid.py:263-280)
    res["DetRe"] = res["HOTA_TP"] / np.maximum(
        1, res["HOTA_TP"] + res["HOTA_FN"])
    res["DetPr"] = res["HOTA_TP"] / np.maximum(
        1, res["HOTA_TP"] + res["HOTA_FP"])
    res["DetA"] = res["HOTA_TP"] / np.maximum(
        1, res["HOTA_TP"] + res["HOTA_FN"] + res["HOTA_FP"])
    res["HOTA"] = np.sqrt(res["DetA"] * res["AssA"])
    res["RHOTA"] = np.sqrt(res["DetRe"] * res["AssA"])
    res["FA-HOTA"] = np.sqrt(res["DetA"]
                             * np.sqrt(res["AssA"] * res["FragA"]))
    res["FA-RHOTA"] = np.sqrt(res["DetRe"]
                              * np.sqrt(res["AssA"] * res["FragA"]))

    float_fields = ("HOTA", "DetA", "AssA", "FragA", "DetRe", "DetPr",
                    "AssRe", "AssPr", "LocA", "RHOTA", "FA-HOTA",
                    "FA-RHOTA")
    for k in float_fields:
        res[k] = np.concatenate(
            [res[k], res[k].mean(axis=1, keepdims=True)], axis=1)
    for k in ("HOTA_TP", "HOTA_FN", "HOTA_FP"):
        res[k] = np.concatenate(
            [res[k], res[k].sum(axis=1, keepdims=True)], axis=1)
    res["HOTA(0)"] = float(res["HOTA"][0, -1])
    res["LocA(0)"] = float(res["LocA"][0, -1])
    res["HOTALocA(0)"] = res["HOTA(0)"] * res["LocA(0)"]
    return res


def keypoint_mota_per_joint(sequences, n_joints: int = 15) -> dict:
    """Per-joint keypoint MOTA — the poseval evaluateTracking breakdown
    the reference prints as "Pose tracking - keypoints MOTA"
    (posetrack21_evaluator.py:138-161: per-joint MOTA columns + the
    total). Matching follows the PCKh convention: a predicted joint can
    match a GT joint of the same frame when the head-normalized
    distance is <= 0.5 (similarity = 1 - dist, threshold 0.5), with
    CLEAR's prefer-previous-assignment identity bookkeeping per joint.

    sequences: {name: [(gt_ids, gt_kps (N, J, >=2), head_sizes,
    pr_ids, pr_kps)]}. Returns {"per_joint_MOTA": (J,),
    "total_MOTA": float, "per_joint": [clear dicts]}.
    """
    from tracklab_torch.eval.metrics import SequenceData, clear_metrics

    per_joint = []
    for j in range(n_joints):
        gt_ids_l, pr_ids_l, sims = [], [], []
        gmap, pmap = {}, {}
        n_g = n_p = 0
        for frames in sequences.values():
            for gt_ids, gt_kps, head_sizes, pr_ids, pr_kps in frames:
                gt_kps = _as_kps(gt_kps, len(gt_ids), n_joints)
                pr_kps = _as_kps(pr_kps, len(pr_ids), n_joints)
                g_ok = (gt_kps[:, j, 0] > 0) & (gt_kps[:, j, 1] > 0)
                p_ok = (pr_kps[:, j, 0] > 0) & (pr_kps[:, j, 1] > 0)
                gi = np.asarray(gt_ids, int)[g_ok]
                pi = np.asarray(pr_ids, int)[p_ok]
                for i in gi:
                    gmap.setdefault(int(i), len(gmap))
                for i in pi:
                    pmap.setdefault(int(i), len(pmap))
                hs = np.asarray(head_sizes, float)[g_ok]
                d = np.linalg.norm(
                    gt_kps[g_ok][:, None, j, :2]
                    - pr_kps[p_ok][None, :, j, :2], axis=-1)
                d = d / np.maximum(hs, 1e-12)[:, None]
                sims.append(np.clip(1.0 - d, 0.0, 1.0))
                gt_ids_l.append(np.array([gmap[int(i)] for i in gi],
                                         int))
                pr_ids_l.append(np.array([pmap[int(i)] for i in pi],
                                         int))
                n_g += len(gi)
                n_p += len(pi)
        data = SequenceData(len(gmap), len(pmap), n_g, n_p,
                            gt_ids_l, pr_ids_l, sims)
        per_joint.append(clear_metrics(data, threshold=0.5))
    motas = np.array([c["MOTA"] for c in per_joint])
    fn = sum(c["CLR_FN"] for c in per_joint)
    fp = sum(c["CLR_FP"] for c in per_joint)
    idsw = sum(c["IDSW"] for c in per_joint)
    n_gt = sum(c["CLR_gt"] for c in per_joint)
    total = float((1 - (fn + fp + idsw) / max(n_gt, 1)) * 100)
    return {"per_joint_MOTA": motas, "total_MOTA": total,
            "per_joint": per_joint}
