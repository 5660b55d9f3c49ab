"""SoccerNet datasets: game-state reconstruction (GSR) and MOT tracking
(counterpart of tracklab_torch.wrappers.dataset.soccernet).

Each video directory's ``Labels-GameState.json`` (images, and annotations
carrying bbox_image, bbox_pitch and the role / team / jersey attributes)
becomes a TrackingSet; ``save_for_eval`` writes the GSR challenge's JSON
predictions and zip. Nothing is downloaded unless ``download=True`` and the
SoccerNet SDK is installed.
"""
from __future__ import annotations

import json
import logging
import zipfile
from pathlib import Path

import numpy as np
import pandas as pd

from tracklab_torch.datastruct.tracking_dataset import (
    TrackingDataset, TrackingSet,
)
from tracklab_torch.wrappers.dataset.mot_like import MOT

log = logging.getLogger(__name__)

__all__ = ["SoccerNetGameState", "SoccerNetMOT"]


def _load_gs_split(split_dir: Path, counters: dict, nvid: int,
                   vids_names) -> TrackingSet:
    video_rows, image_rows, det_rows = [], [], []
    video_dirs = sorted(p for p in split_dir.iterdir() if p.is_dir())
    if vids_names:
        video_dirs = [p for p in video_dirs if p.name in vids_names]
    if nvid >= 1:
        video_dirs = video_dirs[:nvid]
    for vdir in video_dirs:
        label_file = vdir / "Labels-GameState.json"
        if not label_file.exists():
            log.warning("No Labels-GameState.json in %s", vdir)
            continue
        with open(label_file) as fp:
            data = json.load(fp)
        video_id = counters["video"]
        counters["video"] += 1
        images = data.get("images", [])
        video_rows.append({
            "id": video_id, "name": vdir.name, "nframes": len(images),
            "frame_rate": 25, "seqlength": len(images),
            "im_width": int(images[0].get("width", 1920)) if images
            else 1920,
            "im_height": int(images[0].get("height", 1080)) if images
            else 1080,
        })
        img_map = {}
        for i, img in enumerate(images):
            image_id = counters["image"]
            counters["image"] += 1
            img_map[img["image_id"]] = image_id
            image_rows.append({
                "id": image_id, "video_id": video_id, "frame": i + 1,
                "file_path": str(vdir / "img1"
                                 / Path(img["file_name"]).name),
                "is_labeled": bool(img.get("is_labeled", True)),
            })
        for ann in data.get("annotations", []):
            if ann.get("supercategory", "object") != "object":
                continue
            if ann.get("image_id") not in img_map:
                continue
            det_id = counters["detection"]
            counters["detection"] += 1
            bbox = ann.get("bbox_image", {})
            attrs = ann.get("attributes", {}) or {}
            det_rows.append({
                "id": det_id,
                "image_id": img_map[ann["image_id"]],
                "video_id": video_id,
                "track_id": int(ann.get("track_id", -1)),
                "bbox_ltwh": np.array([
                    bbox.get("x", 0), bbox.get("y", 0),
                    bbox.get("w", 0), bbox.get("h", 0)], np.float32),
                "bbox_conf": 1.0,
                "bbox_pitch": ann.get("bbox_pitch"),
                "category_id": int(ann.get("category_id", 1)),
                "role": attrs.get("role"),
                "team": attrs.get("team"),
                "jersey_number": attrs.get("jersey"),
            })
    video_df = pd.DataFrame(video_rows).set_index("id") if video_rows \
        else pd.DataFrame(columns=["name", "nframes"]).rename_axis("id")
    image_df = pd.DataFrame(image_rows).set_index("id") if image_rows \
        else pd.DataFrame(columns=["video_id", "frame",
                                   "file_path"]).rename_axis("id")
    det_df = pd.DataFrame(det_rows).set_index("id") if det_rows \
        else pd.DataFrame(columns=[
            "image_id", "video_id", "track_id", "bbox_ltwh",
            "category_id"]).rename_axis("id")
    if len(det_df):
        det_df = det_df.join(image_df["frame"], on="image_id")
    return TrackingSet(video_df, image_df, det_df)


def download_dataset(dataset_path,
                     splits=("train", "valid", "test", "challenge"),
                     task: str = "gamestate-2025"):
    """Fetch and unzip the SoccerNet game-state dataset through the
    SoccerNet SDK. The SDK is imported here; where it is absent this raises
    ImportError naming it."""
    try:
        from SoccerNet.Downloader import SoccerNetDownloader
    except ImportError as e:
        raise ImportError(
            "SoccerNet dataset download requires the 'SoccerNet' SDK "
            "(pip install SoccerNet); alternatively download manually "
            "per https://github.com/SoccerNet/sn-gamestate") from e
    dataset_path = Path(dataset_path)
    downloader = SoccerNetDownloader(LocalDirectory=str(dataset_path))
    downloader.downloadDataTask(task=task, split=list(splits))
    for split in splits:
        zpath = dataset_path / task / f"{split}.zip"
        if not zpath.exists():
            log.warning("downloaded archive missing: %s", zpath)
            continue
        log.info("Unzipping %s split...", split)
        with zipfile.ZipFile(zpath, "r") as zf:
            zf.extractall(dataset_path / split)


class SoccerNetGameState(TrackingDataset):
    name = "SoccerNetGS"
    nickname = "sngs"

    def __init__(self, dataset_path: str, nvid: int = -1,
                 nframes: int = -1, vids_dict: dict | None = None,
                 download: bool = False, **kwargs):
        dataset_path = Path(dataset_path)
        vids_dict = vids_dict or {}
        splits = ("train", "valid", "test", "challenge")
        if download and not any((dataset_path / s).exists()
                                for s in splits):
            download_dataset(dataset_path, splits)
        counters = {"video": 0, "image": 0, "detection": 0}
        sets = {}
        for split in splits:
            sdir = dataset_path / split
            if sdir.exists():
                sets[split] = _load_gs_split(
                    sdir, counters, nvid, vids_dict.get(split))
        super().__init__(str(dataset_path), sets, nvid=-1,
                         nframes=nframes, **kwargs)

    # the GSR challenge's prediction export
    @classmethod
    def save_for_eval(cls, detections, image_metadatas, video_metadatas,
                      save_folder, bbox_column_for_eval="bbox_ltwh",
                      save_classes=False, is_ground_truth=False,
                      save_zip=True):
        if is_ground_truth:
            return
        save_path = Path(save_folder)
        save_path.mkdir(parents=True, exist_ok=True)
        dets = detections.copy()
        need = [c for c in ("track_id", "bbox_ltwh") if c in dets]
        dets = dets.dropna(subset=need)
        records_by_video = {}
        for idx, det in dets.iterrows():
            box = np.asarray(det["bbox_ltwh"], float)
            rec = {
                "id": int(idx),
                "image_id": int(det["image_id"]),
                "track_id": int(det["track_id"]),
                "supercategory": "object",
                "category_id": int(det.get("category_id", 1)),
                "bbox_image": {
                    "x": float(box[0]), "y": float(box[1]),
                    "w": float(box[2]), "h": float(box[3]),
                    "x_center": float(box[0] + box[2] / 2),
                    "y_center": float(box[1] + box[3] / 2),
                },
                "attributes": {
                    "role": det.get("role"),
                    "jersey": det.get("jersey_number"),
                    "team": det.get("team"),
                },
            }
            if det.get("bbox_pitch") is not None and \
                    not (isinstance(det.get("bbox_pitch"), float)
                         and np.isnan(det.get("bbox_pitch"))):
                rec["bbox_pitch"] = det["bbox_pitch"]
            records_by_video.setdefault(det["video_id"], []).append(rec)
        zf_path = save_path.parent / f"{save_path.name}.zip"
        for vid, video in video_metadatas.iterrows():
            preds = records_by_video.get(vid, [])
            fp = save_path / f"{video['name']}.json"
            with open(fp, "w") as f:
                json.dump({"predictions": preds}, f, indent=2)
            if save_zip:
                with zipfile.ZipFile(zf_path, "a",
                                     zipfile.ZIP_DEFLATED) as zf:
                    zf.write(fp, arcname=f"{save_path.name}/{fp.name}")

    def process_trackeval_results(self, results, dataset_config=None,
                                  eval_config=None):
        if "COMBINED_SEQ" in results:
            combined = dict(results["COMBINED_SEQ"])
            if "HOTA" in combined:
                combined["GS-HOTA"] = combined["HOTA"]
                log.info("GS-HOTA = %.3f%%", combined["GS-HOTA"])
            results["COMBINED_SEQ"] = combined
        return results


class SoccerNetMOT(MOT):
    """SoccerNet tracking in MOT format."""
    name = "SoccerNetMOT"
    nickname = "snmot"
    splits = ["train", "test", "challenge"]
    categories = [{"id": 1, "name": "person"}]
