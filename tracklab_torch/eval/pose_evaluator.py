"""PoseTrack evaluator (counterpart of tracklab_tpu.eval.pose_evaluator):
box tracking metrics (HOTA, CLEAR, Identity on ``track_bbox_ltwh``), box
mAP, pose tracking HOTA with OKS similarity, keypoint mAP, the cross-video
reid keypoint HOTA, and per-joint PCKh AP and MOTA, per video in parallel
threads on the host and combined.
"""
from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pandas as pd

from tracklab_torch.eval.evaluator import _frames_dict
from tracklab_torch.eval.metrics import (
    combine_sequences, evaluate_sequence, make_sequence_data,
)
from tracklab_torch.eval.pose_metrics import (
    keypoint_map, make_pose_sequence_data,
)
from tracklab_torch.pipeline.levels import Evaluator

log = logging.getLogger(__name__)

__all__ = ["PoseTrackEvaluator", "PoseTrack21Evaluator",
           "PoseTrack18Evaluator"]


def _pose_frames(dets: pd.DataFrame, images: pd.DataFrame, id_col: str):
    out_kp, out_ids, out_scores = {}, {}, {}
    if len(dets) == 0 or "keypoints_xyc" not in dets.columns:
        return out_ids, out_kp, out_scores
    merged = dets.merge(images[["frame"]], left_on="image_id",
                        right_index=True, suffixes=("", "_img"))
    frame_col = "frame_img" if "frame_img" in merged else "frame"
    merged = merged.dropna(subset=["keypoints_xyc"])
    if id_col in merged.columns:
        merged = merged.dropna(subset=[id_col])
    for frame, g in merged.groupby(frame_col):
        kps = np.stack(g["keypoints_xyc"].to_numpy())
        out_kp[int(frame)] = kps
        out_scores[int(frame)] = (
            g["bbox_conf"].to_numpy(float)
            if "bbox_conf" in g else np.ones(len(g)))
        if id_col in g.columns:
            out_ids[int(frame)] = g[id_col].to_numpy(float).astype(int)
    return out_ids, out_kp, out_scores


class PoseTrackEvaluator(Evaluator):
    def __init__(self, cfg=None, eval_set: str = "val",
                 num_parallel: int = 4,
                 pred_track_column: str = "track_id",
                 eval_reid_pose_tracking: bool = True, **kwargs):
        super().__init__(cfg)
        self.eval_set = eval_set
        self.num_parallel = num_parallel
        self.pred_track_column = pred_track_column
        self.eval_reid_pose_tracking = eval_reid_pose_tracking

    def run(self, tracker_state):
        images = tracker_state.image_metadatas
        videos = tracker_state.video_metadatas
        gt = tracker_state.detections_gt
        pred = tracker_state.detections_pred
        if pred is None or len(pred) == 0:
            log.warning("No predictions to evaluate")
            return {}
        if self.pred_track_column not in pred.columns:
            # a tracker that confirmed no track adds no track column; the
            # JAX package's evaluator raises KeyError on such a run
            # (ROADMAP §3), the port scores it as a run without tracks
            pred = pred.assign(**{self.pred_track_column: np.nan})

        def eval_video(video_id):
            vimgs = images[images.video_id == video_id]
            vgt = gt[gt.video_id == video_id] if len(gt) else gt
            vpred = pred[pred.video_id == video_id]
            out = {}
            # box tracking metrics
            gtf = _frames_dict(vgt, vimgs, "bbox_ltwh", "track_id")
            prf = _frames_dict(vpred, vimgs,
                               "track_bbox_ltwh"
                               if "track_bbox_ltwh" in vpred.columns
                               else "bbox_ltwh", self.pred_track_column)
            out["box"] = evaluate_sequence(make_sequence_data(gtf, prf))
            # detection bbox mAP (the reference's eval_mot branch,
            # posetrack21_evaluator.py:193-201)
            from tracklab_torch.eval.pose_metrics import box_map

            def _boxes_scores(df, col):
                boxes, scores = {}, {}
                if len(df) == 0 or col not in df.columns:
                    return boxes, scores
                m = df.dropna(subset=[col]).merge(
                    vimgs[["frame"]], left_on="image_id",
                    right_index=True, suffixes=("", "_img"))
                fcol = "frame_img" if "frame_img" in m else "frame"
                for fr, g in m.groupby(fcol):
                    boxes[int(fr)] = np.stack(g[col].to_numpy())
                    scores[int(fr)] = (
                        g["bbox_conf"].to_numpy(float)
                        if "bbox_conf" in g else np.ones(len(g)))
                return boxes, scores

            bb_g, _ = _boxes_scores(vgt, "bbox_ltwh")
            pcol = ("track_bbox_ltwh"
                    if "track_bbox_ltwh" in vpred.columns
                    else "bbox_ltwh")
            bb_p, bb_s = _boxes_scores(vpred, pcol)
            out["bbox_map"] = box_map(bb_g, bb_p, bb_s)
            # pose tracking (OKS HOTA) + keypoint mAP
            g_ids, g_kp, _ = _pose_frames(vgt, vimgs, "track_id")
            p_ids, p_kp, p_sc = _pose_frames(vpred, vimgs,
                                             self.pred_track_column)
            if g_kp and p_kp:
                pose_gt = {f: (g_ids[f], g_kp[f]) for f in g_ids}
                pose_pr = {f: (p_ids[f], p_kp[f]) for f in p_ids}
                out["pose"] = evaluate_sequence(
                    make_pose_sequence_data(pose_gt, pose_pr))
                out["map"] = keypoint_map(g_kp, p_kp, p_sc)
            return out

        per_seq = {}
        with ThreadPoolExecutor(max(self.num_parallel, 1)) as pool:
            futures = {vid: pool.submit(eval_video, vid)
                       for vid in videos.index}
            for vid, fut in futures.items():
                name = videos.loc[vid, "name"] if "name" in videos \
                    else vid
                per_seq[str(name)] = fut.result()

        results = {
            "COMBINED_SEQ": combine_sequences(
                {k: v["box"] for k, v in per_seq.items()}),
            "per_seq": per_seq,
        }
        bmaps = [v["bbox_map"]["bbox_mAP"] for v in per_seq.values()
                 if "bbox_map" in v]
        if bmaps:
            results["bbox_mAP"] = float(np.mean(bmaps))
            log.info("bbox mAP %.2f", results["bbox_mAP"])
        pose_seqs = {k: v["pose"] for k, v in per_seq.items()
                     if "pose" in v}
        if pose_seqs:
            results["POSE_COMBINED"] = combine_sequences(pose_seqs)
            maps = [v["map"]["kp_mAP"] for v in per_seq.values()
                    if "map" in v]
            results["kp_mAP"] = float(np.mean(maps))
            log.info("Pose HOTA %.3f | kp mAP %.3f",
                     results["POSE_COMBINED"]["HOTA"],
                     results["kp_mAP"])
            if self.eval_reid_pose_tracking:
                reid = self._reid_pose_eval(gt, pred, images, videos)
                if reid is not None:
                    results["REID_POSE"] = reid
                    log.info("Reid-pose HOTA(0.05) %.3f",
                             reid["HOTA"][0, -1])
            aps = self._per_joint_ap(gt, pred, images, videos)
            if aps is not None:
                results["kp_AP_per_joint"] = aps
                log.info("kp AP per joint: total %.2f", aps["total_AP"])
            motas = self._per_joint_mota(gt, pred, images, videos)
            if motas is not None:
                results["kp_MOTA_per_joint"] = motas
                log.info("kp MOTA per joint: total %.2f",
                         motas["total_MOTA"])
        for k in ("HOTA", "MOTA", "IDF1"):
            log.info("  box %-6s %10.3f", k, results["COMBINED_SEQ"][k])
        return results

    # ------------------------------------------------------------------
    def _head_sizes(self, dets: pd.DataFrame) -> np.ndarray:
        """Per-row PCKh head sizes: 0.6 * diag(bbox_head) when the
        dataset carries head boxes (the fork's _get_head_size,
        posetrack.py:128-130); otherwise 1/6 of the keypoint-bbox
        diagonal (documented fallback — no head annotations exist
        outside PoseTrack)."""
        if "bbox_head" in dets.columns and dets["bbox_head"].notna().any():
            hs = []
            for hb, kp in zip(dets["bbox_head"], dets["keypoints_xyc"]):
                if hb is not None and not np.any(pd.isna(hb)):
                    l, t, w, h = np.asarray(hb, float)[:4]
                    hs.append(0.6 * float(np.hypot(w, h)))
                else:
                    kp = np.asarray(kp, float)
                    ok = kp[:, 0] > 0
                    d = (np.ptp(kp[ok, :2], axis=0) if ok.any()
                         else np.ones(2))
                    hs.append(float(np.hypot(*d)) / 6.0)
            return np.asarray(hs, float)
        hs = []
        for kp in dets["keypoints_xyc"]:
            kp = np.asarray(kp, float)
            ok = kp[:, 0] > 0
            d = np.ptp(kp[ok, :2], axis=0) if ok.any() else np.ones(2)
            hs.append(float(np.hypot(*d)) / 6.0)
        return np.asarray(hs, float)

    def _pose_reid_frames(self, dets, images, id_col):
        """Per-video frame lists for the reid metric: (ids, kps (N,J,2),
        head_sizes) keyed (video, frame). Pred side gets unit head
        sizes (the metric normalizes by GT heads only)."""
        if len(dets) == 0 or "keypoints_xyc" not in dets.columns:
            return None
        dets = dets.dropna(subset=["keypoints_xyc"])
        if id_col not in dets.columns:
            return None
        dets = dets.dropna(subset=[id_col])
        if len(dets) == 0:
            return None
        dets = dets.copy()
        dets["_hs"] = self._head_sizes(dets)
        merged = dets.merge(images[["frame", "video_id"]],
                            left_on="image_id", right_index=True,
                            suffixes=("", "_img"))
        vcol = ("video_id_img" if "video_id_img" in merged
                else "video_id")
        fcol = "frame_img" if "frame_img" in merged else "frame"
        out = {}
        for (vid, frame), g in merged.groupby([vcol, fcol]):
            kps = np.stack(g["keypoints_xyc"].to_numpy())[:, :, :2]
            out[(vid, int(frame))] = (
                g[id_col].to_numpy(float).astype(int), kps,
                g["_hs"].to_numpy(float))
        return out

    def _reid_pose_eval(self, gt, pred, images, videos):
        """Cross-video reid keypoint HOTA (the reference's
        eval_reid_pose_tracking branch, posetrack21_evaluator.py:
        161-189). GT ids come from person_id (dataset-global); pred ids
        from person_id when a cross-video reid stage produced one, else
        the track column (documented: per-video track ids then score no
        cross-video association credit)."""
        from tracklab_torch.eval.pose_reid_metrics import (
            reid_keypoint_hota, relabel_global_ids,
        )
        gt_col = "person_id" if "person_id" in gt.columns else "track_id"
        pr_col = ("person_id" if "person_id" in pred.columns
                  and pred["person_id"].notna().any()
                  else self.pred_track_column)
        g = self._pose_reid_frames(gt, images, gt_col)
        p = self._pose_reid_frames(pred, images, pr_col)
        if not g or not p:
            return None
        n_joints = next(iter(g.values()))[1].shape[1]
        seqs = {}
        for vid in videos.index:
            frames = sorted({f for (v, f) in list(g) + list(p)
                             if v == vid})
            if not frames:
                continue
            seqs[str(vid)] = [
                (g.get((vid, f), (np.zeros(0, int),
                                  np.zeros((0, n_joints, 2)),
                                  np.zeros(0)))[0],
                 g.get((vid, f), (None, np.zeros((0, n_joints, 2)),
                                  None))[1],
                 g.get((vid, f), (None, None, np.zeros(0)))[2],
                 p.get((vid, f), (np.zeros(0, int),
                                  np.zeros((0, n_joints, 2)),
                                  np.zeros(0)))[0],
                 p.get((vid, f), (None, np.zeros((0, n_joints, 2)),
                                  None))[1])
                for f in frames]
        relabeled, n_gt, n_pr = relabel_global_ids(seqs)
        if n_gt == 0 or n_pr == 0:
            return None
        return reid_keypoint_hota(relabeled, n_gt, n_pr,
                                  n_joints=n_joints)

    def _per_joint_mota(self, gt, pred, images, videos):
        """Per-joint keypoint MOTA (the reference's poseval
        evaluateTracking breakdown, posetrack21_evaluator.py:138-161),
        on per-video track ids."""
        from tracklab_torch.eval.pose_reid_metrics import (
            keypoint_mota_per_joint,
        )
        g = self._pose_reid_frames(gt, images, "track_id")
        p = self._pose_reid_frames(pred, images,
                                   self.pred_track_column)
        if not g or not p:
            return None
        n_joints = next(iter(g.values()))[1].shape[1]
        seqs = {}
        for vid in videos.index:
            frames = sorted({f for (v, f) in list(g) + list(p)
                             if v == vid})
            if not frames:
                continue
            empty = (np.zeros(0, int),
                     np.zeros((0, n_joints, 2)), np.zeros(0))
            rows = []
            for f in frames:
                ge = g.get((vid, f), empty)
                pe = p.get((vid, f), empty)
                # (gt_ids, gt_kps, head_sizes, pr_ids, pr_kps)
                rows.append((ge[0], ge[1], ge[2], pe[0], pe[1]))
            seqs[str(vid)] = rows
        return keypoint_mota_per_joint(seqs, n_joints=n_joints)

    def _per_joint_ap(self, gt, pred, images, videos):
        """Per-joint PCKh keypoint AP (the reference's poseval
        evaluateAP breakdown, posetrack21_evaluator.py:78-105),
        aggregated over all videos."""
        from tracklab_torch.eval.pose_metrics import keypoint_ap_per_joint
        g = self._pose_reid_frames(gt, images,
                                   "track_id" if "track_id" in gt.columns
                                   else "id")
        if not g:
            return None
        if len(pred) == 0 or "keypoints_xyc" not in pred.columns:
            return None
        predk = pred.dropna(subset=["keypoints_xyc"])
        merged = predk.merge(images[["frame", "video_id"]],
                             left_on="image_id", right_index=True,
                             suffixes=("", "_img"))
        vcol = ("video_id_img" if "video_id_img" in merged
                else "video_id")
        fcol = "frame_img" if "frame_img" in merged else "frame"
        gt_frames, pr_frames, pr_scores, head_sizes = {}, {}, {}, {}
        key = 0
        index = {}
        for (vid, f), (ids, kps, hs) in g.items():
            index[(vid, f)] = key
            gt_frames[key] = kps
            head_sizes[key] = hs
            key += 1
        for (vid, frame), grp in merged.groupby([vcol, fcol]):
            k = index.get((vid, int(frame)))
            if k is None:
                continue
            pr_frames[k] = np.stack(
                grp["keypoints_xyc"].to_numpy())[:, :, :2]
            pr_scores[k] = (grp["bbox_conf"].to_numpy(float)
                            if "bbox_conf" in grp
                            else np.ones(len(grp)))
        if not pr_frames:
            return None
        n_joints = next(iter(gt_frames.values())).shape[1]
        return keypoint_ap_per_joint(gt_frames, pr_frames, pr_scores,
                                     head_sizes, n_joints=n_joints)


class PoseTrack21Evaluator(PoseTrackEvaluator):
    """Name-compatible alias (reference:
    wrappers/eval/posetrack/posetrack21_evaluator.py)."""


class PoseTrack18Evaluator(PoseTrackEvaluator):
    """Name-compatible alias (reference: posetrack18_evaluator.py)."""
