"""PoseTrack18/21 datasets: COCO-style JSON annotations, one file per video
(counterpart of tracklab_tpu.wrappers.dataset.posetrack, kept as the
port's own copy).

Each ``annotation_path/{split}/<video>.json`` holds ``images`` (frame
metadata with ``is_labeled`` and, where the dataset marks them, the
ignore-region polygons ``ignore_regions_x``/``ignore_regions_y``, which
``callbacks/handle_regions.py:IgnoredRegions`` reads per image) and
``annotations`` (box, 17 keypoints as flat [x, y, visibility] triplets,
``track_id`` and the dataset-wide ``person_id``). An annotation without a
box gets the box around its visible keypoints.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import pandas as pd

from tracklab_torch.datastruct.tracking_dataset import (TrackingDataset,
                                                        TrackingSet)

log = logging.getLogger(__name__)

__all__ = ["PoseTrack21", "PoseTrack18"]


def _load_split(anns_path: Path, dataset_path: Path, counters: dict):
    """One split's videos, images and annotations; ``counters`` hands out
    the video, image and detection ids across splits."""
    video_rows, image_rows, det_rows = [], [], []
    for path in sorted(anns_path.glob("*.json")):
        with open(path) as fp:
            data = json.load(fp)
        images = data.get("images", [])
        if not images:
            continue
        video_id = counters["video"]
        counters["video"] += 1
        video_rows.append({
            "id": video_id, "name": path.stem, "nframes": len(images),
            "frame_rate": 30, "seqlength": len(images),
        })
        img_id_map = {}
        for frame_i, img in enumerate(images):
            image_id = counters["image"]
            counters["image"] += 1
            img_id_map[img["id"]] = image_id
            row = {
                "id": image_id, "video_id": video_id,
                "frame": frame_i + 1,
                "file_path": str(dataset_path / img["file_name"]),
                "is_labeled": bool(img.get("is_labeled", True)),
            }
            if "ignore_regions_x" in img:
                row["ignore_regions_x"] = img["ignore_regions_x"]
                row["ignore_regions_y"] = img["ignore_regions_y"]
            image_rows.append(row)
        for ann in data.get("annotations", []):
            if ann.get("image_id") not in img_id_map:
                continue
            det_id = counters["detection"]
            counters["detection"] += 1
            kp = np.asarray(ann.get("keypoints", []),
                            np.float32).reshape(-1, 3)
            bbox = ann.get("bbox")
            if bbox is None and len(kp):
                vis = kp[:, 2] > 0
                if vis.any():
                    x1, y1 = kp[vis, 0].min(), kp[vis, 1].min()
                    x2, y2 = kp[vis, 0].max(), kp[vis, 1].max()
                    bbox = [x1, y1, x2 - x1, y2 - y1]
            det_rows.append({
                "id": det_id,
                "image_id": img_id_map[ann["image_id"]],
                "video_id": video_id,
                "track_id": int(ann.get("track_id", -1)),
                "bbox_ltwh": (np.asarray(bbox, np.float32)
                              if bbox is not None
                              else np.zeros(4, np.float32)),
                "bbox_conf": 1.0,
                "keypoints_xyc": kp,
                "category_id": int(ann.get("category_id", 1)),
                "person_id": ann.get("person_id", -1),
            })
    video_df = (pd.DataFrame(video_rows).set_index("id") if video_rows
                else pd.DataFrame(columns=["name", "nframes"])
                .rename_axis("id"))
    image_df = (pd.DataFrame(image_rows).set_index("id") if image_rows
                else pd.DataFrame(columns=["video_id", "frame", "file_path"])
                .rename_axis("id"))
    det_df = (pd.DataFrame(det_rows).set_index("id") if det_rows
              else pd.DataFrame(columns=[
                  "image_id", "video_id", "track_id", "bbox_ltwh",
                  "keypoints_xyc", "category_id"]).rename_axis("id"))
    if len(det_df):
        # the frame column on detections, for the MOT-format export
        det_df = det_df.join(image_df["frame"], on="image_id")
    return TrackingSet(video_df, image_df, det_df)


class PoseTrack21(TrackingDataset):
    name = "posetrack21"
    nickname = "ptt"
    posetrack_version = 21

    def __init__(self, dataset_path: str, annotation_path: str,
                 nvid: int = -1, nframes: int = -1, **kwargs):
        dataset_path = Path(dataset_path)
        annotation_path = Path(annotation_path)
        counters = {"video": 0, "image": 0, "detection": 0}
        sets = {}
        for split in ("train", "val", "test"):
            split_dir = annotation_path / split
            if split_dir.exists():
                sets[split] = _load_split(split_dir, dataset_path, counters)
        super().__init__(str(dataset_path), sets, nvid=nvid,
                         nframes=nframes, **kwargs)


class PoseTrack18(PoseTrack21):
    name = "posetrack18"
    nickname = "pt18"
    posetrack_version = 18
