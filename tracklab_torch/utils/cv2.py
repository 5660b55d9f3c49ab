"""Image loading and box crops for the engine's loader (counterpart of
``register_virtual_renderer``, ``cv2_load_image`` and ``crop_bbox`` in
tracklab_tpu.utils.cv2).

Virtual schemes (``synthetic://...``) render in numpy and need no OpenCV.
A file path or a ``vid://path:frame`` reference imports ``cv2`` when it is
asked for and raises ImportError naming it where it is absent.
"""
from __future__ import annotations

import functools

import numpy as np

__all__ = ["register_virtual_renderer", "cv2_load_image", "crop_bbox"]

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


@functools.lru_cache(maxsize=8)
def _video_capture(path: str):
    cap = _cv2().VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(path)
    return cap


def cv2_load_image(file_path) -> np.ndarray:
    """An RGB uint8 image from a registered virtual scheme, a
    ``vid://path:frame`` video frame or an image file."""
    file_path = str(file_path)
    scheme, sep, rest = file_path.partition("://")
    if sep and scheme in _VIRTUAL_RENDERERS:
        return _VIRTUAL_RENDERERS[scheme](rest)
    cv2 = _cv2()
    if sep and scheme == "vid":
        path, frame = rest.rsplit(":", 1)
        cap = _video_capture(path)
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(frame))
        ok, image = cap.read()
        if not ok:
            raise IndexError(f"frame {frame} of {path}")
    else:
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
