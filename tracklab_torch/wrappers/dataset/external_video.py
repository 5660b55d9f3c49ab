"""Track any mp4, folder of frames or webcam as a dataset (counterpart of
tracklab_tpu.wrappers.dataset.external_video).

Builds a one-split ("val") TrackingSet without ground truth. A video's
image rows name ``vid://file:frame`` paths, decoded on demand through
``utils/cv2.py``'s VideoReader, so the offline engines run on a video
without extracting its frames; the online engine reads the file itself.
"""
from __future__ import annotations

import logging
from pathlib import Path

import pandas as pd

from tracklab_torch.datastruct.tracking_dataset import (
    TrackingDataset, TrackingSet,
)

log = logging.getLogger(__name__)

__all__ = ["ExternalVideo"]

VIDEO_EXTS = {".mp4", ".avi", ".mov", ".mkv", ".webm"}
IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp"}


def _download_video(url: str, download_dir: str | None = None) -> str:
    """Fetch a video URL with yt-dlp and return the local file's path;
    yt-dlp is optional, and an ImportError names it where it is absent."""
    try:
        import yt_dlp
    except ImportError as e:
        raise ImportError(
            "ExternalVideo got a URL but yt-dlp is not installed; "
            "pip install yt-dlp or pass a local file path") from e
    yt_params = {"noplaylist": True, "restrictfilenames": True}
    if download_dir:
        yt_params["paths"] = {"home": str(download_dir)}
    with yt_dlp.YoutubeDL(yt_params) as ydl:
        return ydl.prepare_filename(ydl.extract_info(url))


class ExternalVideo(TrackingDataset):
    """``video_path``: a video file, a folder of videos, a folder of frames
    (one video) or an http(s) URL (through yt-dlp)."""

    def __init__(self, video_path: str, nvid: int = -1, nframes: int = -1,
                 download_dir: str | None = None, **kwargs):
        import cv2
        if str(video_path).startswith(("http://", "https://")):
            video_path = _download_video(str(video_path), download_dir)
        path = Path(video_path)
        videos = []
        if path.is_dir():
            entries = sorted(path.iterdir())
            vids = [p for p in entries if p.suffix.lower() in VIDEO_EXTS]
            imgs = [p for p in entries if p.suffix.lower() in IMAGE_EXTS]
            if vids:
                videos = vids
            elif imgs:
                videos = [path]  # one video of frames
        elif path.suffix.lower() in VIDEO_EXTS and path.exists():
            videos = [path]
        if not videos:
            raise FileNotFoundError(f"No video(s) at {video_path}")

        video_rows, image_rows = [], []
        image_id = 0
        for vid_id, vp in enumerate(videos):
            if vp.is_dir():
                frames = sorted(p for p in vp.iterdir()
                                if p.suffix.lower() in IMAGE_EXTS)
                n, fps, w, h = len(frames), 30.0, 0, 0
                paths = [str(p) for p in frames]
            else:
                cap = cv2.VideoCapture(str(vp))
                n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
                fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
                w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
                h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
                cap.release()
                paths = [f"vid://{vp}:{f}" for f in range(n)]
            video_rows.append(dict(
                id=vid_id, name=vp.stem, nframes=n, frame_rate=fps,
                seqlength=n, im_width=w, im_height=h, file_path=str(vp)))
            for f, fp in enumerate(paths):
                image_rows.append(dict(id=image_id, video_id=vid_id,
                                       frame=f + 1, file_path=fp,
                                       is_labeled=False))
                image_id += 1

        det_df = pd.DataFrame(
            columns=["image_id", "video_id", "frame", "track_id",
                     "bbox_ltwh", "bbox_conf",
                     "category_id"]).rename_axis("id")
        ts = TrackingSet(pd.DataFrame(video_rows).set_index("id"),
                         pd.DataFrame(image_rows).set_index("id"), det_df)
        super().__init__(str(path), {"val": ts}, nvid=nvid,
                         nframes=nframes, **kwargs)
