"""TrackEval-style evaluator (counterpart of
tracklab_tpu.eval.evaluator): optionally export predictions in MOT format,
evaluate HOTA/CLEAR/Identity per sequence in parallel on the host, combine
the sequences and log the result."""
from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import pandas as pd

from tracklab_torch.eval.metrics import (
    make_sequence_data, evaluate_sequence, combine_sequences,
)
from tracklab_torch.pipeline.levels import Evaluator
from tracklab_torch.utils.parallel import parallel_map

log = logging.getLogger(__name__)

__all__ = ["TrackEvalEvaluator"]

_PRINT_KEYS = ["HOTA", "DetA", "AssA", "LocA", "MOTA", "MOTP", "IDF1",
               "IDSW", "CLR_TP", "CLR_FN", "CLR_FP"]


def _frames_dict(dets: pd.DataFrame, images: pd.DataFrame, bbox_col: str,
                 id_col: str):
    """{frame: (ids, (n, 4) ltwh boxes)} of one sequence's rows."""
    out = {}
    if len(dets) == 0:
        return out
    merged = dets.merge(images[["frame"]], left_on="image_id",
                        right_index=True, suffixes=("", "_img"))
    frame_col = "frame_img" if "frame_img" in merged else "frame"
    merged = merged.dropna(subset=[id_col, bbox_col])
    for frame, g in merged.groupby(frame_col):
        ids = g[id_col].to_numpy(float).astype(int)
        boxes = np.stack(g[bbox_col].to_numpy()).astype(float)
        out[int(frame)] = (ids, boxes)
    return out


def _eval_sequence_worker(frames):
    """Module-level, so a process pool can pickle it."""
    gt_frames, pred_frames = frames
    return evaluate_sequence(make_sequence_data(gt_frames, pred_frames))


class TrackEvalEvaluator(Evaluator):
    """cfg keys: eval_set, save_folder (optional), bbox_column_for_eval,
    num_parallel and parallel_backend (thread | process | serial),
    pred_track_column."""

    def __init__(self, cfg=None, eval_set: str = "val",
                 bbox_column_for_eval: str = "bbox_ltwh",
                 save_folder: str | None = None,
                 num_parallel: int = 4,
                 parallel_backend: str = "thread",
                 pred_track_column: str = "track_id",
                 show_progressbar: bool = False, **kwargs):
        super().__init__(cfg)
        self.eval_set = eval_set
        self.bbox_col = bbox_column_for_eval
        self.save_folder = save_folder
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
        if self.pred_track_column not in pred.columns:
            log.warning("No '%s' column in predictions — did a tracker "
                        "run?", self.pred_track_column)
            return {}
        # drop predictions flagged as inside an ignored region
        if "in_ignored_region" in pred.columns:
            flagged = pred["in_ignored_region"].fillna(False).astype(bool)
            if flagged.any():
                log.info("Excluding %d detections inside ignore regions",
                         int(flagged.sum()))
                pred = pred[~flagged]

        if self.save_folder:
            from tracklab_torch.datastruct.tracking_dataset import \
                TrackingDataset
            export = pred.rename(columns={self.pred_track_column:
                                          "track_id"})
            TrackingDataset.save_for_eval(
                export, images, videos,
                str(Path(self.save_folder) / "pred"), self.bbox_col)

        # pandas slicing here, the metric math in the workers
        def frames_for(video_id):
            vimgs = images[images.video_id == video_id]
            vgt = gt[gt.video_id == video_id] if len(gt) else gt
            vpred = pred[pred.video_id == video_id]
            pr_col = ("track_bbox_ltwh" if "track_bbox_ltwh" in vpred.columns
                      else self.bbox_col)
            return (_frames_dict(vgt, vimgs, "bbox_ltwh", "track_id"),
                    _frames_dict(vpred, vimgs, pr_col,
                                 self.pred_track_column))

        vids = list(videos.index)
        results = parallel_map(_eval_sequence_worker,
                               [frames_for(v) for v in vids],
                               self.num_parallel, self.parallel_backend)
        per_seq = {}
        for vid, res in zip(vids, results):
            name = videos.loc[vid, "name"] if "name" in videos else vid
            per_seq[str(name)] = res
        combined = combine_sequences(per_seq)
        log.info("Evaluation results (COMBINED over %d sequences):",
                 len(per_seq))
        for k in _PRINT_KEYS:
            if k in combined:
                log.info("  %-8s %10.3f", k, combined[k])
        return {"COMBINED_SEQ": combined, "per_seq": per_seq}
