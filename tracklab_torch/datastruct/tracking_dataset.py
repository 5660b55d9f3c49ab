"""Tracking dataset data model (counterpart of
tracklab_tpu.datastruct.tracking_dataset).

A ``TrackingSet`` is four DataFrames (video_metadatas, image_metadatas,
detections_gt, image_gt), and a ``detections_public`` DataFrame where the
dataset has public detections; a ``TrackingDataset`` maps a split name to
a set, with nvid/nframes/vids_dict subsampling and MOT-format export. The JAX
package's person-disjoint set splits (for ReID training) wait for training.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import numpy as np
import pandas as pd

log = logging.getLogger(__name__)

__all__ = ["TrackingSet", "TrackingDataset", "SetsDict"]


class TrackingSet:
    def __init__(self, video_metadatas: pd.DataFrame,
                 image_metadatas: pd.DataFrame,
                 detections_gt: pd.DataFrame,
                 image_gt: Optional[pd.DataFrame] = None):
        self.video_metadatas = video_metadatas
        self.image_metadatas = image_metadatas
        self.detections_gt = detections_gt
        self.image_gt = image_gt if image_gt is not None else \
            image_metadatas.copy()

    def filter_videos(self, video_ids) -> "TrackingSet":
        """Restrict the set, in place, to the given video ids."""
        video_ids = list(video_ids)
        self.video_metadatas = self.video_metadatas[
            self.video_metadatas.index.isin(video_ids)]
        self.image_metadatas = self.image_metadatas[
            self.image_metadatas["video_id"].isin(video_ids)]
        if len(self.detections_gt):
            self.detections_gt = self.detections_gt[
                self.detections_gt["video_id"].isin(video_ids)]
        if self.image_gt is not None and len(self.image_gt):
            self.image_gt = self.image_gt[
                self.image_gt.index.isin(self.image_metadatas.index)]
        return self


class SetsDict(dict):
    def __getitem__(self, key):
        if key not in self:
            raise KeyError(
                f"Split '{key}' not found in dataset. "
                f"Available splits: {list(self.keys())}")
        return super().__getitem__(key)


class TrackingDataset:
    def __init__(self, dataset_path: str, sets: dict,
                 nvid: int = -1, nframes: int = -1,
                 vids_dict: Optional[dict] = None, *args, **kwargs):
        self.dataset_path = Path(dataset_path)
        self.sets = SetsDict(sets)
        vids_dict = vids_dict or {}
        for split, s in self.sets.items():
            self.sets[split] = self._subsample(
                s, nvid, nframes, vids_dict.get(split))

    def _subsample(self, tracking_set: Optional[TrackingSet], nvid, nframes,
                   vids_names):
        """nvid/nframes truncation and selection of videos by name."""
        if tracking_set is None:
            return None
        if nvid < 1 and nframes < 1 and not vids_names:
            return tracking_set
        videos = tracking_set.video_metadatas
        if vids_names:
            assert set(vids_names).issubset(set(videos["name"])), \
                f"Unknown videos {set(vids_names) - set(videos['name'])}"
            videos = videos[videos["name"].isin(vids_names)]
        elif nvid >= 1:
            videos = videos.head(nvid)
        images = tracking_set.image_metadatas
        images = images[images["video_id"].isin(videos.index)]
        if nframes >= 1:
            # each video's first nframes rows (groupby.apply would drop the
            # video_id column under pandas 3)
            images = images[images.groupby("video_id").cumcount() < nframes]
        dets = tracking_set.detections_gt
        if len(dets):
            dets = dets[dets["image_id"].isin(images.index)]
        image_gt = tracking_set.image_gt
        if image_gt is not None and len(image_gt):
            image_gt = image_gt[image_gt.index.isin(images.index)]
        subset = TrackingSet(videos, images, dets, image_gt)
        public = getattr(tracking_set, "detections_public", None)
        if public is not None:
            # the JAX package drops a set's public detections here
            subset.detections_public = public[
                public["image_id"].isin(images.index)]
        return subset

    # ------------------------------------------------------------------
    # MOTChallenge-format export for evaluation
    # ------------------------------------------------------------------
    @staticmethod
    def _mot_encoding(detections: pd.DataFrame,
                      image_metadatas: pd.DataFrame,
                      bbox_column: str) -> pd.DataFrame:
        image_metadatas = image_metadatas.copy()
        image_metadatas["id"] = image_metadatas.index
        df = pd.merge(image_metadatas.reset_index(drop=True),
                      detections.reset_index(drop=True),
                      left_on="id", right_on="image_id",
                      suffixes=("", "_det"))
        len_before = len(df)
        df.dropna(subset=["frame", "track_id", bbox_column], how="any",
                  inplace=True)
        if len(df) != len_before:
            log.warning("Dropped %d detections without frame/track_id/bbox "
                        "during MOT encoding", len_before - len(df))
        boxes = np.stack(df[bbox_column].to_numpy()) if len(df) else \
            np.zeros((0, 4))
        for i, name in enumerate(("bb_left", "bb_top", "bb_width",
                                  "bb_height")):
            df[name] = boxes[:, i]
        if "bbox_conf" not in df:
            df["bbox_conf"] = 1.0
        return df.assign(x=-1, y=-1, z=-1)

    @classmethod
    def save_for_eval(cls, detections: pd.DataFrame,
                      image_metadatas: pd.DataFrame,
                      video_metadatas: pd.DataFrame,
                      save_folder: str,
                      bbox_column_for_eval: str = "bbox_ltwh"):
        """One MOTChallenge txt per video (frame, id, bb_left, bb_top,
        bb_width, bb_height, conf, x, y, z) and a seqmaps file."""
        save_path = Path(save_folder)
        save_path.mkdir(parents=True, exist_ok=True)
        seqmap = ["name"] + [str(n) for n in video_metadatas["name"]]
        (save_path.parent / "seqmaps.txt").write_text(
            "\n".join(seqmap) + "\n")
        if detections.empty:
            for name in video_metadatas["name"]:
                (save_path / f"{name}.txt").write_text("")
            return
        mot_df = cls._mot_encoding(detections, image_metadatas,
                                   bbox_column_for_eval)
        cols = ["frame", "track_id", "bb_left", "bb_top", "bb_width",
                "bb_height", "bbox_conf", "x", "y", "z"]
        for video_id, video in video_metadatas.iterrows():
            out = mot_df.loc[mot_df["video_id"] == video_id, cols].copy()
            out["frame"] = out["frame"].astype(int)
            out["track_id"] = out["track_id"].astype(int)
            out.to_csv(save_path / f"{video['name']}.txt",
                       header=False, index=False)
