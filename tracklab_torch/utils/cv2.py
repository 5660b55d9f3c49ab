"""Image loading, box crops and drawing (counterpart of
tracklab_tpu.utils.cv2).

Virtual schemes (``synthetic://...``) render in numpy and need no OpenCV.
A file path or a ``vid://path:frame`` reference imports ``cv2`` when it is
asked for and raises ImportError naming it where it is absent.
"""
from __future__ import annotations

import functools
import threading
from collections import OrderedDict

import numpy as np

__all__ = ["register_virtual_renderer", "cv2_load_image", "crop_bbox",
           "VideoReader", "draw_bbox", "draw_text", "draw_keypoints"]

_VIRTUAL_RENDERERS: dict = {}


def register_virtual_renderer(scheme: str, fn):
    """Register a loader for ``{scheme}://rest`` image paths; ``fn`` takes
    the remainder and returns an RGB uint8 (H, W, 3) array."""
    _VIRTUAL_RENDERERS[scheme] = fn


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "loading image files needs OpenCV (the 'cv2' module), which is "
            "not importable here; virtual schemes such as synthetic:// "
            "need no OpenCV") from e
    return cv2


class VideoReader:
    """Frames of a video file by index, for ``vid://path:frame`` paths.

    Reads go forward from the last frame read and the last ``KEEP`` frames
    are kept, so frames asked for in or near their order (the loader's
    threads ask a few at once, in any order) are decoded once each; a frame
    behind that window, or more than ``AHEAD`` frames ahead, is sought (a
    seek decodes from the previous key frame). Safe to share between
    threads."""

    AHEAD = 32
    KEEP = 16

    def __init__(self, filename: str):
        cv2 = _cv2()
        self.filename = filename
        self.cap = cv2.VideoCapture(filename)
        if not self.cap.isOpened():
            raise FileNotFoundError(filename)
        self.num_frames = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self._pos = 0             # the frame the next read returns
        self._frames = OrderedDict()
        self._lock = threading.Lock()

    def __getitem__(self, idx: int) -> np.ndarray:
        cv2 = _cv2()
        with self._lock:
            if idx not in self._frames:
                if not self._pos <= idx < self._pos + self.AHEAD:
                    self.cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
                    self._pos = idx
                while self._pos <= idx:
                    ok, frame = self.cap.read()
                    if not ok:
                        raise IndexError(f"frame {idx} of {self.filename}")
                    self._frames[self._pos] = cv2.cvtColor(
                        frame, cv2.COLOR_BGR2RGB)
                    self._pos += 1
                    while len(self._frames) > self.KEEP:
                        self._frames.popitem(last=False)
            return self._frames[idx].copy()


@functools.lru_cache(maxsize=8)
def _video_reader(path: str) -> VideoReader:
    return VideoReader(path)


def cv2_load_image(file_path) -> np.ndarray:
    """An RGB uint8 image from a registered virtual scheme, a
    ``vid://path:frame`` video frame or an image file."""
    file_path = str(file_path)
    scheme, sep, rest = file_path.partition("://")
    if sep and scheme in _VIRTUAL_RENDERERS:
        return _VIRTUAL_RENDERERS[scheme](rest)
    if sep and scheme == "vid":
        path, frame = rest.rsplit(":", 1)
        return _video_reader(path)[int(frame)]
    cv2 = _cv2()
    image = cv2.imread(file_path)
    if image is None:
        raise FileNotFoundError(file_path)
    return cv2.cvtColor(image, cv2.COLOR_BGR2RGB)


def crop_bbox(image: np.ndarray, bbox_ltwh, pad: int = 0) -> np.ndarray:
    """The pixels of an ltwh box (grown by ``pad``), clamped to the image;
    a 1 x 1 black crop where the clamped box is empty."""
    h, w = image.shape[:2]
    l, t, bw, bh = np.asarray(bbox_ltwh, float)
    x1 = int(max(l - pad, 0))
    y1 = int(max(t - pad, 0))
    x2 = int(min(l + bw + pad, w))
    y2 = int(min(t + bh + pad, h))
    if x2 <= x1 or y2 <= y1:
        return np.zeros((1, 1, image.shape[2]), image.dtype)
    return image[y1:y2, x1:x2]


def draw_bbox(image, bbox_ltwh, color=(0, 255, 0), thickness=2, text=None,
              text_color=(255, 255, 255)):
    """An ltwh box drawn in place, with ``text`` on a filled label above
    it."""
    cv2 = _cv2()
    l, t, w, h = [int(round(float(v))) for v in bbox_ltwh]
    cv2.rectangle(image, (l, t), (l + w, t + h), color, thickness)
    if text is not None:
        draw_text(image, text, (l, max(t - 6, 12)), color=text_color,
                  bg_color=color)
    return image


def draw_text(image, text, org, scale=0.5, color=(255, 255, 255),
              thickness=1, bg_color=None):
    """``text`` drawn in place at ``org`` (its baseline's left end), on a
    filled ``bg_color`` box when one is given."""
    cv2 = _cv2()
    if bg_color is not None:
        (tw, th), baseline = cv2.getTextSize(
            str(text), cv2.FONT_HERSHEY_SIMPLEX, scale, thickness)
        x, y = org
        cv2.rectangle(image, (x, y - th - baseline),
                      (x + tw, y + baseline), bg_color, -1)
    cv2.putText(image, str(text), org, cv2.FONT_HERSHEY_SIMPLEX, scale,
                color, thickness, cv2.LINE_AA)
    return image


# COCO-17 skeleton (pairs of keypoint indices)
COCO_SKELETON = [
    (15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11), (6, 12),
    (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2), (0, 1), (0, 2),
    (1, 3), (2, 4), (3, 5), (4, 6),
]


def draw_keypoints(image, keypoints_xyc, color=(0, 255, 0), radius=3,
                   threshold=0.0, skeleton=True):
    """(K, 2 or 3) keypoints drawn in place: those whose score is above
    ``threshold``, and the COCO-17 skeleton's limbs between them."""
    cv2 = _cv2()
    kp = np.asarray(keypoints_xyc, float)
    vis = kp[:, 2] > threshold if kp.shape[1] > 2 else \
        np.ones(len(kp), bool)
    if skeleton and len(kp) == 17:
        for a, b in COCO_SKELETON:
            if vis[a] and vis[b]:
                cv2.line(image, (int(kp[a, 0]), int(kp[a, 1])),
                         (int(kp[b, 0]), int(kp[b, 1])), color, 1,
                         cv2.LINE_AA)
    for i, (x, y) in enumerate(kp[:, :2]):
        if vis[i]:
            cv2.circle(image, (int(x), int(y)), radius, color, -1,
                       cv2.LINE_AA)
    return image
