"""Procedural synthetic tracking dataset (counterpart of
tracklab_tpu.wrappers.dataset.synthetic).

Linear-motion objects with known track ids, optional detection noise,
dropout and false positives, as a full TrackingSet. The same seed gives the
same rows as the JAX package's generator. Frames render on the host from
``synthetic://{video_id}/{frame}`` paths (no files, no OpenCV), so image
modules run on the dataset too. A perfect tracker on the noise-free set
reaches HOTA 100.

The game-state mode (``game_state=True``) films each video with a
broadcast camera (``calibration/camera.py``, f32 on the CPU): image rows
carry the projected pitch-line points a segmenter would see, with 0.5 px of
noise, and detection rows the game-state attributes (team, role, jersey and
their per-detection predictions) and ``bbox_pitch`` through the true
camera.
"""
from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from tracklab_torch.datastruct.tracking_dataset import (
    TrackingDataset, TrackingSet,
)
from tracklab_torch.utils.cv2 import register_virtual_renderer

__all__ = ["SyntheticDataset", "make_synthetic_set"]

# "{video_id}/{frame}" -> (GT boxes ltwh, width, height) for rendering
_RENDER_BOXES: dict = {}


def _render_frame(rest: str) -> np.ndarray:
    boxes, img_w, img_h = _RENDER_BOXES[rest]
    img = np.full((img_h, img_w, 3), 15, np.uint8)
    for k, (x, y, w, h) in enumerate(boxes):
        color = np.array([60 + (k * 53) % 180, 60 + (k * 101) % 180,
                          220 - (k * 37) % 160], np.uint8)
        x1, y1 = int(max(x, 0)), int(max(y, 0))
        x2, y2 = int(min(x + w, img_w)), int(min(y + h, img_h))
        if x2 > x1 and y2 > y1:
            img[y1:y2, x1:x2] = color
    return img


def _gs_camera(img_w, img_h, pan=0.0):
    """A video's broadcast camera (the wide main view), f32 on the CPU."""
    from tracklab_torch.calibration.camera import CameraParams

    def f32(v):
        return torch.tensor(v, dtype=torch.float32)
    return CameraParams(
        pan=f32(pan), tilt=f32(1.25), roll=f32(0.01),
        focal=f32(1100.0 * img_w / 1920.0),
        position=f32([0.0, 55.0, 18.0]),
        principal=f32([img_w / 2.0, img_h / 2.0]))


def _gs_pitch_lines(cam, img_w, img_h, rng, noise=0.5):
    """The pitch-marking points inside the image, per segment with at least
    4 of them, with ``noise`` px of Gaussian noise."""
    from tracklab_torch.calibration.camera import project_points
    from tracklab_torch.calibration.pitch import pitch_segments
    obs = {}
    for name, pts in pitch_segments().items():
        px, front = project_points(cam, torch.tensor(pts,
                                                     dtype=torch.float32))
        px, front = px.numpy(), front.numpy()
        inside = (front & (px[:, 0] > 0) & (px[:, 0] < img_w)
                  & (px[:, 1] > 0) & (px[:, 1] < img_h))
        if inside.sum() >= 4:
            obs[name] = (px[inside]
                         + rng.normal(0, noise, (int(inside.sum()), 2))
                         ).astype(np.float32)
    return obs


def _gs_bbox_pitch(cam, boxes):
    """GT boxes -> bbox_pitch dicts through the true camera."""
    from tracklab_torch.calibration.camera import backproject_to_pitch
    boxes = np.asarray(boxes, float)
    bl = np.stack([boxes[:, 0], boxes[:, 1] + boxes[:, 3]], 1)
    br = np.stack([boxes[:, 0] + boxes[:, 2], boxes[:, 1] + boxes[:, 3]], 1)
    world = backproject_to_pitch(cam, torch.tensor(
        np.concatenate([bl, br, (bl + br) / 2]), dtype=torch.float32)).numpy()
    n = len(boxes)
    return [{
        "x_bottom_left": float(world[i, 0]),
        "y_bottom_left": float(world[i, 1]),
        "x_bottom_right": float(world[n + i, 0]),
        "y_bottom_right": float(world[n + i, 1]),
        "x_bottom_middle": float(world[2 * n + i, 0]),
        "y_bottom_middle": float(world[2 * n + i, 1]),
    } for i in range(n)]


def make_synthetic_set(n_videos=2, n_frames=100, n_objects=8, seed=0,
                       det_noise=0.0, det_dropout=0.0, fp_rate=0.0,
                       img_w=1920, img_h=1080, id_offset=0,
                       with_keypoints=False, n_keypoints=17,
                       game_state=False):
    rng = np.random.default_rng(seed)
    register_virtual_renderer("synthetic", _render_frame)
    video_rows, image_rows, det_rows = [], [], []
    image_id, det_id = id_offset * 100000, id_offset * 1000000
    for v in range(n_videos):
        video_id = id_offset + v
        video_rows.append({
            "id": video_id, "name": f"synth-{video_id:03d}",
            "nframes": n_frames, "frame_rate": 30,
            "seqlength": n_frames, "im_width": img_w, "im_height": img_h,
        })
        # margins scale with the frame so small debug resolutions work
        max_size = min(150.0, img_w / 6.0, img_h / 6.0)
        min_size = max_size / 3.0
        lo = [min(100.0, img_w / 10.0), min(100.0, img_h / 10.0)]
        hi = [img_w - 2 * max_size, img_h - 2 * max_size]
        cam = _gs_camera(img_w, img_h, pan=0.05 * v) if game_state else None
        pos = rng.uniform(lo, hi, (n_objects, 2))
        vel = rng.uniform(-6, 6, (n_objects, 2))
        size = rng.uniform(min_size, max_size, (n_objects, 2))
        # rigid per-object keypoint offsets (fractions of the box)
        kp_frac = rng.uniform(0.05, 0.95, (n_objects, n_keypoints, 2))
        lims = (img_w - 1.2 * max_size, img_h - 1.2 * max_size)
        for f in range(1, n_frames + 1):
            image_row = {
                "id": image_id, "video_id": video_id, "frame": f,
                "file_path": f"synthetic://{video_id}/{f}",
                "is_labeled": True,
            }
            if game_state:
                image_row["pitch_lines"] = _gs_pitch_lines(cam, img_w, img_h,
                                                           rng)
            image_rows.append(image_row)
            pos = pos + vel
            for d, lim in enumerate(lims):   # bounce off the borders
                hit = (pos[:, d] < 0) | (pos[:, d] > lim)
                vel[hit, d] *= -1
            pos = np.clip(pos, 0, list(lims))
            _RENDER_BOXES[f"{video_id}/{f}"] = (
                np.concatenate([pos, size], axis=1).astype(np.float32),
                img_w, img_h)
            for k in range(n_objects):
                if det_dropout and rng.uniform() < det_dropout:
                    continue
                c = pos[k] + rng.normal(0, det_noise, 2) \
                    if det_noise else pos[k]
                s = size[k]
                row = {
                    "id": det_id, "image_id": image_id,
                    "video_id": video_id, "frame": f, "track_id": k + 1,
                    "bbox_ltwh": np.array([c[0], c[1], s[0], s[1]],
                                          np.float32),
                    "bbox_conf": float(rng.uniform(0.75, 1.0)),
                    "category_id": 1, "visibility": 1.0,
                }
                if with_keypoints:
                    kp = np.ones((n_keypoints, 3), np.float32)
                    kp[:, :2] = c[None, :] + kp_frac[k] * s[None, :]
                    row["keypoints_xyc"] = kp
                    row["keypoints_conf"] = 1.0
                if game_state:
                    # GT attributes and the per-detection predictions the
                    # attribute heads would emit
                    team = "left" if k % 2 == 0 else "right"
                    role = "goalkeeper" if k == 0 else "player"
                    row.update(team=team, role=role, jersey_number=k + 1,
                               team_detection=team, team_confidence=1.0,
                               role_detection=role, role_confidence=1.0,
                               jersey_number_detection=k + 1,
                               jersey_number_confidence=1.0)
                    row["bbox_pitch"] = _gs_bbox_pitch(
                        cam, row["bbox_ltwh"][None])[0]
                det_rows.append(row)
                det_id += 1
            if fp_rate:
                for _ in range(rng.poisson(fp_rate)):
                    c = rng.uniform([0, 0], [img_w - 150, img_h - 150])
                    s = rng.uniform(30, 100, 2)
                    det_rows.append({
                        "id": det_id, "image_id": image_id,
                        "video_id": video_id, "frame": f, "track_id": -1,
                        "bbox_ltwh": np.array([c[0], c[1], s[0], s[1]],
                                              np.float32),
                        "bbox_conf": float(rng.uniform(0.3, 0.7)),
                        "category_id": 1, "visibility": 1.0,
                    })
                    det_id += 1
            image_id += 1
    return TrackingSet(pd.DataFrame(video_rows).set_index("id"),
                       pd.DataFrame(image_rows).set_index("id"),
                       pd.DataFrame(det_rows).set_index("id"))


class SyntheticDataset(TrackingDataset):
    def __init__(self, dataset_path: str = "/tmp/synthetic",
                 n_videos: int = 2, n_frames: int = 100,
                 n_objects: int = 8, seed: int = 0,
                 det_noise: float = 0.0, det_dropout: float = 0.0,
                 fp_rate: float = 0.0, nvid: int = -1, nframes: int = -1,
                 img_w: int = 1920, img_h: int = 1080,
                 with_keypoints: bool = False,
                 game_state: bool = False, **kwargs):
        common = dict(img_w=img_w, img_h=img_h,
                      with_keypoints=with_keypoints, game_state=game_state)
        sets = {
            "train": make_synthetic_set(
                n_videos, n_frames, n_objects, seed, det_noise,
                det_dropout, fp_rate, **common),
            "val": make_synthetic_set(
                n_videos, n_frames, n_objects, seed + 1, det_noise,
                det_dropout, fp_rate, id_offset=n_videos, **common),
        }
        super().__init__(dataset_path, sets, nvid=nvid, nframes=nframes,
                         **kwargs)
