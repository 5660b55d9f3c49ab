"""Tracklet-level attribute vote (counterpart of
tracklab_tpu.wrappers.tracklet_agg.majority_vote).

Per track, each ``{attr}_detection`` column (weighted by
``{attr}_confidence`` where present) collapses to the value with the
largest total confidence, written back onto every row of the tracklet as
``{attr}`` (jersey numbers, team and role in the game-state pipeline).
"""
from __future__ import annotations

import numpy as np
import pandas as pd

from tracklab_torch.pipeline.levels import VideoLevelModule

__all__ = ["MajorityVoteTracklet", "select_highest_voted_att"]


def select_highest_voted_att(atts, atts_confidences=None):
    """The value of ``atts`` with the largest summed confidence (each vote
    1 without confidences); None and NaN do not vote; None if no value
    votes."""
    confidence_sum = {}
    if atts_confidences is None:
        atts_confidences = [1] * len(atts)
    for value, conf in zip(atts, atts_confidences):
        if value is None or (isinstance(value, float) and np.isnan(value)):
            continue
        confidence_sum[value] = confidence_sum.get(value, 0) + conf
    if not confidence_sum:
        return None
    return max(confidence_sum, key=confidence_sum.get)


class MajorityVoteTracklet(VideoLevelModule):
    input_columns: list = []
    output_columns: list = []

    def __init__(self, attributes, device=None, tracking_dataset=None,
                 **kwargs):
        self.attributes = list(attributes)
        self.input_columns = ["track_id"] + [f"{a}_detection"
                                             for a in self.attributes]
        self.output_columns = list(self.attributes)

    def process(self, detections: pd.DataFrame,
                metadatas: pd.DataFrame) -> pd.DataFrame:
        out = pd.DataFrame(index=detections.index)
        for attribute in self.attributes:
            out[attribute] = pd.Series(np.nan, index=out.index,
                                       dtype=object)
        if "track_id" not in detections.columns:
            return out
        for track_id in detections.track_id.dropna().unique():
            tracklet = detections[detections.track_id == track_id]
            for attribute in self.attributes:
                conf_col = f"{attribute}_confidence"
                confs = tracklet[conf_col] \
                    if conf_col in tracklet.columns else None
                out.loc[tracklet.index, attribute] = select_highest_voted_att(
                    list(tracklet[f"{attribute}_detection"]),
                    None if confs is None else list(confs))
        return out
