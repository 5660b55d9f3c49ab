"""TrackerState: run state, persistence and resume (counterpart of
tracklab_tpu.datastruct.tracker_state).

Accumulates predicted detections and image metadata; persists them as a
zip of pickles ({video_id}.pkl, {video_id}_image.pkl and a summary.json
column manifest), the same file layout as the JAX package's, so a state
file written by one package loads in the other. Supports column-level
resume (loaded columns = stored columns minus the pipeline's outputs, plus
its inputs) and bootstrapping from the ground truth, from a dataset's
public detections or from a COCO-style JSON file of detections
(``json_file``).
"""
from __future__ import annotations

import json
import logging
import pickle
import zipfile
from pathlib import Path
from typing import Optional

import numpy as np
import pandas as pd

from tracklab_torch.pipeline.module import Pipeline

log = logging.getLogger(__name__)

__all__ = ["TrackerState"]

_BASE_DET_COLUMNS = ["image_id", "video_id", "category_id"]
_BASE_IMG_COLUMNS = ["video_id", "frame", "file_path"]


class TrackerState:
    def __init__(self, tracking_set, pipeline: Optional[Pipeline] = None,
                 save_file=None, load_file=None, json_file=None,
                 load_from_groundtruth: bool = False,
                 load_from_public_dets: bool = False, **kwargs):
        self.pipeline = pipeline if pipeline is not None else Pipeline([])
        self.save_file = Path(save_file) if save_file else None
        self.load_file = Path(load_file) if load_file else None
        self.json_file = json_file
        self.load_from_groundtruth = load_from_groundtruth
        self.load_from_public_dets = load_from_public_dets
        self.after_saved_state = True  # callback ordering flag

        self.video_metadatas = tracking_set.video_metadatas
        self.image_metadatas = tracking_set.image_metadatas
        self.detections_gt = tracking_set.detections_gt
        self.image_gt = tracking_set.image_gt

        self.detections_pred: Optional[pd.DataFrame] = None
        self.image_pred: Optional[pd.DataFrame] = None
        self.video_id = None
        self.zf = {}

        if json_file is not None:
            self.json_detections_pred = self._load_json_detections(
                json_file)

        # the ground truth acts as an upstream module, so trackers run
        # without a detector; a dict value keeps only the listed columns
        # (e.g. leave track_id out when testing a tracker on GT boxes)
        if load_from_groundtruth:
            dets = self.detections_gt.copy()
            if "bbox_conf" not in dets and len(dets):
                dets["bbox_conf"] = 1.0
            if isinstance(load_from_groundtruth, dict):
                keep = load_from_groundtruth.get("detection")
                if keep:
                    base = ["image_id", "video_id", "frame"]
                    dets = dets[[c for c in dict.fromkeys(base + list(keep))
                                 if c in dets.columns]]
            self.detections_pred_gt = dets
        if load_from_public_dets:
            dets = getattr(tracking_set, "detections_public", None)
            if dets is None:
                raise ValueError("load_from_public_dets: the dataset "
                                 "provides no public detections")
            self.detections_public = dets.copy()

        levels = ("detection", "image")
        self.input_columns = {lv: set() for lv in levels}
        self.output_columns = {lv: set() for lv in levels}
        for level in levels:
            for m in self.pipeline:
                self.input_columns[level].update(m.get_input_columns(level))
                self.output_columns[level].update(
                    m.get_output_columns(level))
        stored = self._stored_columns()
        self.load_columns = {}
        for level, base in (("detection", _BASE_DET_COLUMNS),
                            ("image", _BASE_IMG_COLUMNS)):
            cols = set(stored.get(level, [])) - self.output_columns[level]
            cols |= self.input_columns[level] | set(base)
            if load_from_groundtruth and level == "detection":
                cols |= set(self.detections_pred_gt.columns)
            if json_file is not None and level == "detection":
                cols |= set(self.json_detections_pred.columns)
            self.load_columns[level] = cols
        self.pipeline.validate(self.load_columns)

    # ------------------------------------------------------------------
    def _load_json_detections(self, json_file):
        """External detections from a COCO-style JSON file: a list of
        records, or a dict holding one under ``annotations`` or
        ``detections``, each with image_id, bbox (ltwh), score and
        optionally keypoints and category_id. Records of images the set
        does not hold are dropped."""
        with open(json_file) as fp:
            data = json.load(fp)
        records = data if isinstance(data, list) else \
            data.get("annotations", data.get("detections", []))
        rows = []
        img_video = self.image_metadatas["video_id"]
        for rec in records:
            image_id = rec.get("image_id")
            if image_id not in img_video.index:
                continue
            row = {
                "image_id": image_id,
                "video_id": img_video.loc[image_id],
                "bbox_ltwh": np.asarray(rec.get("bbox",
                                                rec.get("bbox_ltwh")),
                                        np.float32),
                "bbox_conf": float(rec.get("score",
                                           rec.get("bbox_conf", 1.0))),
                "category_id": int(rec.get("category_id", 1)),
            }
            if "keypoints" in rec:
                row["keypoints_xyc"] = np.asarray(
                    rec["keypoints"], np.float32).reshape(-1, 3)
            rows.append(row)
        df = pd.DataFrame(rows)
        df.index.name = "id"
        return df

    def _stored_columns(self):
        if self.load_file is None or not self.load_file.exists():
            return {}
        with zipfile.ZipFile(self.load_file) as zf:
            if "summary.json" in zf.namelist():
                with zf.open("summary.json") as fp:
                    return json.load(fp)["columns"]
        return {}

    # ------------------------------------------------------------------
    # per-video context manager
    # ------------------------------------------------------------------
    def __call__(self, video_id):
        self.video_id = video_id
        return self

    def __enter__(self):
        # load_file == save_file is the crash-resume workflow: the read
        # handle keeps the old central directory (offsets stay valid under
        # append), the append handle writes new entries and a fresh
        # directory at close
        if self.load_file is not None and self.load_file.exists():
            self.zf["load"] = zipfile.ZipFile(self.load_file, "r")
        if self.save_file is not None:
            self.save_file.parent.mkdir(parents=True, exist_ok=True)
            self.zf["save"] = zipfile.ZipFile(
                self.save_file, "a", zipfile.ZIP_DEFLATED, allowZip64=True)
        return self

    def __exit__(self, *exc):
        for z in self.zf.values():
            z.close()
        self.zf = {}
        self.video_id = None
        return False

    # ------------------------------------------------------------------
    def load(self):
        """This video's detections and image metadata to start its
        pipeline run from."""
        assert self.video_id is not None, \
            "load() must be called inside the per-video context manager"
        video_images = self.image_metadatas[
            self.image_metadatas.video_id == self.video_id]
        if self.json_file is not None:
            video_detections = self.json_detections_pred[
                self.json_detections_pred.video_id == self.video_id]
            self.update(video_detections, video_images)
            return video_detections, video_images
        video_detections = pd.DataFrame()
        if self.load_from_groundtruth:
            video_detections = self.detections_pred_gt[
                self.detections_pred_gt.video_id == self.video_id]
        if self.load_from_public_dets:
            video_detections = self.detections_public[
                self.detections_public.video_id == self.video_id]
        if self.load_file is not None and "load" in self.zf:
            zf = self.zf["load"]
            name = f"{self.video_id}.pkl"
            if name in zf.namelist():
                with zf.open(name) as fp:
                    df = pickle.load(fp)
                cols = [c for c in self.load_columns["detection"]
                        if c in df.columns]
                video_detections = df[cols]
                video_detections = video_detections[
                    video_detections["image_id"].isin(video_images.index)]
            else:
                log.info("%s detections not in state file", self.video_id)
                video_detections = pd.DataFrame(
                    columns=sorted(self.load_columns["detection"]))
            iname = f"{self.video_id}_image.pkl"
            if iname in zf.namelist():
                with zf.open(iname) as fp:
                    imgs = pickle.load(fp)
                cols = [c for c in self.load_columns["image"]
                        if c in imgs.columns]
                index = video_images.index
                video_images = video_images.combine_first(imgs[cols])
                video_images = video_images[video_images.index.isin(index)]
        self.update(video_detections, video_images)
        return video_detections, video_images

    def update(self, detections: pd.DataFrame, image_metadata: pd.DataFrame):
        """Replace this video's rows in the accumulated predictions."""
        if self.detections_pred is None:
            self.detections_pred = detections
            self.image_pred = image_metadata
            return

        def others(df):
            return df[df["video_id"] != self.video_id] if len(df) else df

        self.detections_pred = pd.concat([others(self.detections_pred),
                                          detections])
        self.image_pred = pd.concat([others(self.image_pred),
                                     image_metadata])

    def save(self):
        """Persist this video's predictions unless they are stored already,
        so resume is per video."""
        if self.save_file is None or self.zf.get("save") is None:
            return
        assert self.video_id is not None
        assert self.detections_pred is not None, \
            "detections_pred must not be None when saving"
        zf = self.zf["save"]
        if f"{self.video_id}.pkl" in zf.namelist():
            log.info("%s already saved in %s", self.video_id,
                     self.save_file)
            return
        if "summary.json" not in zf.namelist():
            summary = {"columns": {
                "detection": list(self.detections_pred.columns),
                "image": list(self.image_pred.columns),
            }}
            zf.writestr("summary.json",
                        json.dumps(summary, ensure_ascii=False, indent=4))
        if not self.detections_pred.empty:
            dets = self.detections_pred[
                self.detections_pred.video_id == self.video_id]
            zf.writestr(f"{self.video_id}.pkl", pickle.dumps(dets))
        if self.image_pred is not None and not self.image_pred.empty:
            imgs = self.image_pred[self.image_pred.video_id == self.video_id]
            zf.writestr(f"{self.video_id}_image.pkl", pickle.dumps(imgs))

    # callback hooks: the state sits in the callback chain, so it saves at a
    # fixed point between the "before" and "after" callbacks
    def on_video_loop_end(self, engine, video_metadata, video_idx,
                          detections, image_pred):
        self.update(detections, image_pred)
        self.save()

    def on_dataset_track_end(self, engine=None):
        log.info("Tracking ended, final TrackerState stats:")
        self.display_stats()

    def display_stats(self):
        if self.detections_pred is not None:
            log.info("detections_pred: %d rows, columns: %s",
                     len(self.detections_pred),
                     list(self.detections_pred.columns))
        if self.image_pred is not None:
            log.info("image_pred: %d rows", len(self.image_pred))
