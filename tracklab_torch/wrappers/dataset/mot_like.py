"""MOTChallenge-format datasets (counterpart of
tracklab_tpu.wrappers.dataset.mot_like): MOT17, MOT20, DanceTrack,
SportsMOT and BEE24 share one reader.

Each split directory (train, val, test) holds one directory per sequence
with ``seqinfo.ini``, the frames (``imDir``/000001``imExt``), ``gt/gt.txt``
and, with ``public_dets``, ``det/det.txt``. The sequences become TrackingSet
DataFrames with integer ids counted across the whole dataset: the splits
are read one after the other in the order of ``splits`` and the sequences
in name order, so the ids do not depend on thread timing.
"""
from __future__ import annotations

import configparser
import logging
from pathlib import Path

import numpy as np
import pandas as pd

from tracklab_torch.datastruct.tracking_dataset import (TrackingDataset,
                                                        TrackingSet)

log = logging.getLogger(__name__)

__all__ = ["MOT", "MOT17", "MOT20", "DanceTrack", "SportsMOT", "Bee24"]


class MOT(TrackingDataset):
    """A MOT-format dataset; subclasses set the name and categories."""

    name = "MOT"
    nickname = "mot"
    splits = ["train", "val", "test"]
    categories = [{"id": 1, "name": "pedestrian"}]

    def __init__(self, dataset_path: str, nvid: int = -1, nframes: int = -1,
                 vids_dict: dict | None = None, public_dets: bool = False,
                 **kwargs):
        self.public_dets = public_dets
        dataset_path = Path(dataset_path)
        counters = {"video": 0, "image": 0, "detection": 0}
        sets = {split: self._load_split(dataset_path, split, counters)
                for split in self.splits if (dataset_path / split).exists()}
        if not sets:
            log.warning("No splits found under %s", dataset_path)
        super().__init__(str(dataset_path), sets, nvid=nvid,
                         nframes=nframes, vids_dict=vids_dict, **kwargs)

    def _load_split(self, root: Path, split: str, counters) -> TrackingSet:
        video_rows, image_rows, det_rows, pub_rows = [], [], [], []
        for seq_dir in sorted(p for p in (root / split).iterdir()
                              if p.is_dir()):
            info = self._read_seqinfo(seq_dir)
            video_id = counters["video"]
            counters["video"] += 1
            nframes = int(info.get("seqlength", 0))
            img_dir = seq_dir / info.get("imdir", "img1")
            ext = info.get("imext", ".jpg")
            video_rows.append({
                "id": video_id, "name": seq_dir.name, "nframes": nframes,
                "frame_rate": float(info.get("framerate", 30)),
                "seqlength": nframes,
                "im_width": int(info.get("imwidth", 1920)),
                "im_height": int(info.get("imheight", 1080)),
            })
            first = counters["image"]
            counters["image"] += nframes
            image_rows += [{"id": first + f - 1, "video_id": video_id,
                            "frame": f,
                            "file_path": str(img_dir / f"{f:06d}{ext}"),
                            "is_labeled": True}
                           for f in range(1, nframes + 1)]
            det_rows += self._read_boxes(
                seq_dir / "gt" / "gt.txt", video_id, first, nframes,
                counters, gt=True)
            if self.public_dets:
                pub_rows += self._read_boxes(
                    seq_dir / "det" / "det.txt", video_id, first, nframes,
                    counters, gt=False)

        def frame(rows, columns):
            if rows:
                return pd.DataFrame(rows).set_index("id")
            return pd.DataFrame(columns=columns).rename_axis("id")

        ts = TrackingSet(
            frame(video_rows, ["name", "nframes"]),
            frame(image_rows, ["video_id", "frame", "file_path"]),
            frame(det_rows, ["image_id", "video_id", "frame", "track_id",
                             "bbox_ltwh", "bbox_conf", "category_id"]))
        if pub_rows:
            ts.detections_public = frame(pub_rows, [])
        return ts

    @staticmethod
    def _read_boxes(path: Path, video_id, first_image, nframes, counters,
                    gt: bool) -> list:
        """The rows of a MOT box file (frame, id, left, top, width, height,
        conf[, class, visibility]) whose frame lies in the sequence, with
        detection ids from the dataset-wide counter. Public detections
        carry no track id and class 1."""
        if not path.exists():
            return []
        rows = []
        for row in np.loadtxt(path, delimiter=",", ndmin=2):
            f = int(row[0])
            if not 1 <= f <= nframes:
                continue
            det = {"id": counters["detection"],
                   "image_id": first_image + f - 1, "video_id": video_id,
                   "frame": f}
            counters["detection"] += 1
            if gt:
                det["track_id"] = int(row[1])
            det["bbox_ltwh"] = np.array(row[2:6], np.float32)
            det["bbox_conf"] = float(row[6]) if len(row) > 6 else 1.0
            det["category_id"] = (int(row[7]) if gt and len(row) > 7
                                  else 1)
            if gt:
                det["visibility"] = float(row[8]) if len(row) > 8 else 1.0
            rows.append(det)
        return rows

    @staticmethod
    def _read_seqinfo(seq_dir: Path) -> dict:
        path = seq_dir / "seqinfo.ini"
        if not path.exists():
            return {}
        parser = configparser.ConfigParser()
        parser.read(path)
        if "Sequence" in parser:
            return {k.lower(): v for k, v in parser["Sequence"].items()}
        return {}


class MOT17(MOT):
    name = "MOT17"
    nickname = "mot17"


class MOT20(MOT):
    name = "MOT20"
    nickname = "mot20"


class DanceTrack(MOT):
    name = "DanceTrack"
    nickname = "dancetrack"
    categories = [{"id": 1, "name": "dancer"}]


class SportsMOT(MOT):
    name = "SportsMOT"
    nickname = "sportsmot"
    categories = [{"id": 1, "name": "player"}]


class Bee24(MOT):
    name = "BEE24"
    nickname = "bee24"
    categories = [{"id": 1, "name": "bee"}]
