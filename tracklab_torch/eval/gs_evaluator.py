"""Game-state evaluator: GS-HOTA over pitch positions and attributes
(counterpart of tracklab_torch.eval.gs_evaluator), and SoccerAccuracy, the
per-attribute accuracy of IoU-matched detections.
"""
from __future__ import annotations

import logging

import numpy as np
import pandas as pd

from tracklab_torch.eval.gs_metrics import make_gs_sequence_data
from tracklab_torch.eval.metrics import combine_sequences, evaluate_sequence
from tracklab_torch.pipeline.levels import Evaluator
from tracklab_torch.utils.parallel import parallel_map

log = logging.getLogger(__name__)

__all__ = ["GameStateEvaluator", "SoccerAccuracy"]


def _gs_frames(dets: pd.DataFrame, images: pd.DataFrame, id_col: str):
    out = {}
    if len(dets) == 0 or "bbox_pitch" not in dets.columns:
        return out
    merged = dets.merge(images[["frame"]], left_on="image_id",
                        right_index=True, suffixes=("", "_img"))
    frame_col = "frame_img" if "frame_img" in merged else "frame"
    merged = merged.dropna(subset=[id_col, "bbox_pitch"])
    for frame, g in merged.groupby(frame_col):
        ids = g[id_col].to_numpy(float).astype(int)
        pos = np.array([
            [bp.get("x_bottom_middle", 0), bp.get("y_bottom_middle", 0)]
            for bp in g["bbox_pitch"]])
        attrs = [{
            "role": r.get("role"),
            "team": r.get("team"),
            "jersey": r.get("jersey_number", r.get("jersey")),
        } for _, r in g.iterrows()]
        out[int(frame)] = (ids, pos, attrs)
    return out


def _gs_sequence_worker(args):
    """Module-level worker (process-pool picklable)."""
    gtf, prf, dist_tol, use_roles, use_teams, use_jerseys = args
    data = make_gs_sequence_data(gtf, prf, dist_tol, use_roles,
                                 use_teams, use_jerseys)
    return evaluate_sequence(data)


class GameStateEvaluator(Evaluator):
    def __init__(self, cfg=None, eval_set: str = "valid",
                 dist_tol: float = 5.0, use_roles: bool = True,
                 use_teams: bool = True, use_jerseys: bool = True,
                 num_parallel: int = 4,
                 parallel_backend: str = "thread",
                 pred_track_column: str = "track_id", **kwargs):
        super().__init__(cfg)
        self.eval_set = eval_set
        self.dist_tol = dist_tol
        self.use_roles = use_roles
        self.use_teams = use_teams
        self.use_jerseys = use_jerseys
        self.num_parallel = num_parallel
        self.parallel_backend = parallel_backend
        self.pred_track_column = pred_track_column

    def run(self, tracker_state):
        images = tracker_state.image_metadatas
        videos = tracker_state.video_metadatas
        gt = tracker_state.detections_gt
        pred = tracker_state.detections_pred
        if pred is None or len(pred) == 0:
            log.warning("No predictions to evaluate")
            return {}

        def frames_for(video_id):
            vimgs = images[images.video_id == video_id]
            gtf = _gs_frames(gt[gt.video_id == video_id]
                             if len(gt) else gt, vimgs, "track_id")
            prf = _gs_frames(pred[pred.video_id == video_id], vimgs,
                             self.pred_track_column)
            return (gtf, prf, self.dist_tol, self.use_roles,
                    self.use_teams, self.use_jerseys)

        vids = list(videos.index)
        results = parallel_map(_gs_sequence_worker,
                               [frames_for(v) for v in vids],
                               self.num_parallel, self.parallel_backend)
        per_seq = {}
        for vid, res in zip(vids, results):
            name = videos.loc[vid, "name"] if "name" in videos else vid
            per_seq[str(name)] = res
        combined = combine_sequences(per_seq)
        combined["GS-HOTA"] = combined["HOTA"]
        combined["GS-DetA"] = combined["DetA"]
        combined["GS-AssA"] = combined["AssA"]
        log.info("GS-HOTA = %.3f%% (tol=%sm, roles=%s teams=%s "
                 "jerseys=%s)", combined["GS-HOTA"], self.dist_tol,
                 self.use_roles, self.use_teams, self.use_jerseys)
        return {"COMBINED_SEQ": combined, "per_seq": per_seq}


class SoccerAccuracy(Evaluator):
    """Per-attribute accuracy for game-state predictions: predictions are
    matched to the ground truth per frame by an optimal assignment on
    1 - IoU, pairs with IoU >= ``iou_threshold`` kept, then each attribute
    column present in both (role, team, jersey_number) is scored."""

    def __init__(self, cfg=None, eval_set: str = "valid",
                 iou_threshold: float = 0.5,
                 attributes=("role", "team", "jersey_number"), **kwargs):
        super().__init__(cfg)
        self.eval_set = eval_set
        self.iou_threshold = iou_threshold
        self.attributes = list(attributes)

    def run(self, tracker_state):
        from scipy.optimize import linear_sum_assignment

        gt = tracker_state.detections_gt
        pred = tracker_state.detections_pred
        if pred is None or len(pred) == 0 or len(gt) == 0:
            log.warning("SoccerAccuracy: nothing to evaluate")
            return {}
        attrs = [a for a in self.attributes
                 if a in gt.columns and a in pred.columns]
        correct = {a: 0 for a in attrs}
        total = {a: 0 for a in attrs}
        n_matched = 0
        for image_id, g in gt.groupby("image_id"):
            p = pred[pred.image_id == image_id]
            g = g.dropna(subset=["bbox_ltwh"])
            p = p.dropna(subset=["bbox_ltwh"])
            if len(g) == 0 or len(p) == 0:
                continue
            gb = np.stack(g.bbox_ltwh.to_numpy()).astype(float)
            pb = np.stack(p.bbox_ltwh.to_numpy()).astype(float)
            l = np.maximum(gb[:, None, 0], pb[None, :, 0])
            t = np.maximum(gb[:, None, 1], pb[None, :, 1])
            r = np.minimum(gb[:, None, 0] + gb[:, None, 2],
                           pb[None, :, 0] + pb[None, :, 2])
            b = np.minimum(gb[:, None, 1] + gb[:, None, 3],
                           pb[None, :, 1] + pb[None, :, 3])
            inter = np.clip(r - l, 0, None) * np.clip(b - t, 0, None)
            union = (gb[:, None, 2] * gb[:, None, 3]
                     + pb[None, :, 2] * pb[None, :, 3] - inter)
            iou = inter / np.maximum(union, 1e-9)
            rows, cols = linear_sum_assignment(1.0 - iou)
            for i, j in zip(rows, cols):
                if iou[i, j] < self.iou_threshold:
                    continue
                n_matched += 1
                for a in attrs:
                    gv, pv = g.iloc[i][a], p.iloc[j][a]
                    if pd.isna(gv):
                        continue
                    total[a] += 1
                    if not pd.isna(pv) and str(pv) == str(gv):
                        correct[a] += 1
        results = {f"{a}_accuracy":
                   100.0 * correct[a] / total[a] if total[a] else float("nan")
                   for a in attrs}
        results["matched_detections"] = n_matched
        for k, v in results.items():
            log.info("  %-20s %10.3f", k, v)
        return results
