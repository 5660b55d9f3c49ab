"""ReID sets from tracking ground truth and keypoint prompt masks for ReID
crops (counterpart of tracklab_tpu.wrappers.reid.reid_dataset).

:func:`build_reid_set` crops every ground-truth detection to disk in
torchreid's folder layout (``<pid>_c<video>_<row>.jpg`` under ``train``,
``query`` and ``gallery``), splits the identities into train and test, and
takes one random frame of each test tracklet as its query, the rest as
gallery, with the JAX package's draws from ``np.random.default_rng(seed)``.
"""
from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import pandas as pd

log = logging.getLogger(__name__)

__all__ = ["build_reid_set", "gaussian_keypoint_masks"]


def gaussian_keypoint_masks(keypoints_xyc, crop_hw, bbox_ltwh,
                            sigma_frac: float = 0.08):
    """(K, 3) image-frame keypoints -> (K, h, w) gaussian prompt masks in
    crop coordinates (the KPR keypoint prompts): keypoint k mapped into the
    (h, w) crop of ``bbox_ltwh``, a gaussian of sigma ``sigma_frac *
    max(h, w)`` around it, zero where its confidence is <= 0."""
    h, w = crop_hw
    l, t, bw, bh = np.asarray(bbox_ltwh, float)
    kp = np.asarray(keypoints_xyc, float).copy()
    kp[:, 0] = (kp[:, 0] - l) / max(bw, 1e-6) * w
    kp[:, 1] = (kp[:, 1] - t) / max(bh, 1e-6) * h
    ys = np.arange(h)[:, None]
    xs = np.arange(w)[None, :]
    sigma = sigma_frac * max(h, w)
    masks = np.zeros((len(kp), h, w), np.float32)
    for k, (x, y, c) in enumerate(kp):
        if c <= 0:
            continue
        masks[k] = np.exp(-((xs - x) ** 2 + (ys - y) ** 2)
                          / (2 * sigma ** 2))
    return masks


def build_reid_set(tracking_set, save_dir, crop_size=(256, 128),
                   max_crops_per_id: int = 40, train_ratio: float = 0.6,
                   min_samples_per_id: int = 4, min_h: int = 30,
                   min_w: int = 15, max_ids: int = -1,
                   save_masks: bool = False, seed: int = 0) -> dict:
    """Crop and split a tracking set's ground truth. Returns ``{"train",
    "query", "gallery"}`` DataFrames with columns [path, pid, camid]; the
    crops (and with ``save_masks`` each row's keypoint masks as ``.npy``)
    are written under ``save_dir``. Identities with fewer than
    ``min_samples_per_id`` rows are left out, boxes under ``min_w`` x
    ``min_h`` and frames that do not load are skipped."""
    import cv2

    from tracklab_torch.utils.cv2 import crop_bbox, cv2_load_image

    save_dir = Path(save_dir)
    rng = np.random.default_rng(seed)
    dets = tracking_set.detections_gt
    imgs = tracking_set.image_metadatas
    groups = [(key, g) for key, g in dets.groupby(["video_id", "track_id"])
              if len(g) >= min_samples_per_id]
    if max_ids > 0:
        groups = groups[:max_ids]
    n_train = int(len(groups) * train_ratio)
    order = rng.permutation(len(groups))
    split_of = {gi: "train" if rank < n_train else "test"
                for rank, gi in enumerate(order)}

    rows = {"train": [], "query": [], "gallery": []}
    for pid, ((video_id, _), g) in enumerate(groups):
        split = split_of[pid]
        g = g.head(max_crops_per_id)
        q_idx = rng.integers(0, len(g)) if split == "test" else -1
        for j, (det_id, det) in enumerate(g.iterrows()):
            box = np.asarray(det["bbox_ltwh"], float)
            if box[2] < min_w or box[3] < min_h:
                continue
            try:
                image = cv2_load_image(imgs.loc[det["image_id"], "file_path"])
            except Exception:  # an unreadable frame is left out, as in JAX
                continue
            crop = cv2.resize(crop_bbox(image, box),
                              (crop_size[1], crop_size[0]))
            sub = split if split == "train" else (
                "query" if j == q_idx else "gallery")
            out_dir = save_dir / sub
            out_dir.mkdir(parents=True, exist_ok=True)
            path = out_dir / f"{pid:05d}_c{video_id}_{det_id}.jpg"
            cv2.imwrite(str(path), cv2.cvtColor(crop, cv2.COLOR_RGB2BGR))
            if save_masks and "keypoints_xyc" in det and isinstance(
                    det["keypoints_xyc"], np.ndarray):
                np.save(path.with_suffix(".npy"), gaussian_keypoint_masks(
                    det["keypoints_xyc"], crop_size, box))
            rows[sub].append({"path": str(path), "pid": pid,
                              "camid": int(video_id)})
    out = {k: pd.DataFrame(v) for k, v in rows.items()}
    log.info("build_reid_set: %d train / %d query / %d gallery crops "
             "(%d identities)", len(out["train"]), len(out["query"]),
             len(out["gallery"]), len(groups))
    return out
