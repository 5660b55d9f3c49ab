"""Tracker wrappers: the DataFrame boundary around the port's scan trackers
(counterpart of tracklab_tpu.wrappers.track.scan_tracker).

A tracker is a VideoLevelModule: the whole video's detections are padded
into fixed-capacity tensors once (:func:`_pad_video`), the scan runs on the
module's device, its emissions are read back once and joined onto the
detection rows by row id (columns track_id, track_bbox_ltwh,
track_bbox_conf). The JAX package's streaming (``process_online``) and
multi-video (``process_video_batch``) modes and the embedding trackers'
wrappers are not ported yet.
"""
from __future__ import annotations

import logging

import numpy as np
import pandas as pd
import torch

from tracklab_torch.device import resolve_device
from tracklab_torch.pipeline.levels import VideoLevelModule
from tracklab_torch.trackers.common import Detections

log = logging.getLogger(__name__)

__all__ = ["OCSORT", "ByteTrack"]


def _ltwh_to_ltrb(b):
    b = np.asarray(b, np.float64)
    return np.concatenate([b[..., :2], b[..., :2] + b[..., 2:4]], axis=-1)


def _ltrb_to_ltwh(b):
    b = np.asarray(b, np.float64)
    return np.concatenate([b[..., :2], b[..., 2:4] - b[..., :2]], axis=-1)


def _pad_video(detections: pd.DataFrame, image_pred: pd.DataFrame,
               max_dets: int, n_frame_bucket: int = 64, device=None):
    """A video's detection rows -> fixed-capacity (F, D, ...) Detections on
    ``device``, the number of real frames, and the lut from ``ref`` to the
    row id (row ids may exceed int32).

    F is rounded up to a multiple of ``n_frame_bucket`` (trailing frames
    carry no valid detection), as in the JAX package, so the two give equal
    arrays. A frame with more than ``max_dets`` rows keeps its most
    confident ones.
    """
    frame_ids = list(image_pred.index)
    n_frames = len(frame_ids)
    F = max(-(-n_frames // n_frame_bucket) * n_frame_bucket, n_frame_bucket)
    ltrb = np.zeros((F, max_dets, 4), np.float32)
    conf = np.zeros((F, max_dets), np.float32)
    cls = np.zeros((F, max_dets), np.float32)
    ref = np.full((F, max_dets), -1, np.int64)
    if len(detections):
        by_image = detections.groupby("image_id")
        for f, image_id in enumerate(frame_ids):
            if image_id not in by_image.groups:
                continue
            rows = by_image.get_group(image_id)
            if len(rows) > max_dets:
                log.warning("frame %s has %d detections > capacity %d; "
                            "keeping the %d most confident", image_id,
                            len(rows), max_dets, max_dets)
                rows = rows.sort_values("bbox_conf",
                                        ascending=False).head(max_dets)
            n = len(rows)
            ltrb[f, :n] = _ltwh_to_ltrb(np.stack(rows["bbox_ltwh"]
                                                 .to_numpy()))
            conf[f, :n] = rows["bbox_conf"].to_numpy(np.float32)
            if "category_id" in rows:
                cls[f, :n] = pd.to_numeric(
                    rows["category_id"], errors="coerce").fillna(0.0)
            ref[f, :n] = rows.index.to_numpy()
    valid = ref >= 0
    lut = np.unique(ref[valid])
    ref32 = np.full((F, max_dets), -1, np.int32)
    ref32[valid] = np.searchsorted(lut, ref[valid])
    dev = resolve_device(device)
    dets = Detections(*(torch.from_numpy(a).to(dev)
                        for a in (ltrb, conf, cls, ref32, valid)))
    return dets, n_frames, lut


class _ScanTrackerBase(VideoLevelModule):
    input_columns = ["bbox_ltwh", "bbox_conf", "category_id"]
    output_columns = ["track_id", "track_bbox_ltwh", "track_bbox_conf"]
    # the wrapper's pre-filter, bbox_conf > min_confidence, applied before
    # the tracker sees the detections (the yamls set 0.4)
    min_confidence = 0.0

    def __init__(self, max_dets: int = 64, n_frame_bucket: int = 64,
                 device=None, **kwargs):
        self.max_dets = max_dets
        self.n_frame_bucket = n_frame_bucket
        self.device = resolve_device(device)

    def _prefilter(self, detections: pd.DataFrame) -> pd.DataFrame:
        if len(detections):
            return detections[detections["bbox_conf"] > self.min_confidence]
        return detections

    def _make_config(self):
        raise NotImplementedError

    def _scan_fn(self):
        raise NotImplementedError

    def _init_state(self, cfg):
        raise NotImplementedError

    def _step_fn(self):
        raise NotImplementedError

    def _emissions_to_df(self, out, n_frames, lut):
        """A scan's emissions (leading frame axis, on any device) -> the
        output rows, read back in one go. A coasting track re-emits the
        ref of its last match; the last emission of a row wins."""
        valid, track_id, ltrb, conf, ref = (
            x[:n_frames].cpu().numpy() for x in
            (out.valid, out.track_id, out.ltrb, out.conf, out.ref))
        fs, ts = np.nonzero(valid)
        ok = ref[fs, ts] >= 0
        fs, ts = fs[ok], ts[ok]
        result = pd.DataFrame(index=lut[ref[fs, ts]] if len(fs)
                              else np.zeros(0, int))
        result["track_id"] = track_id[fs, ts].astype(float)
        result["track_bbox_ltwh"] = list(
            _ltrb_to_ltwh(ltrb[fs, ts]).astype(np.float32))
        result["track_bbox_conf"] = conf[fs, ts].astype(float)
        return result[~result.index.duplicated(keep="last")]

    def process(self, detections: pd.DataFrame,
                metadatas: pd.DataFrame) -> pd.DataFrame:
        if len(detections) == 0:
            return detections
        dets, n_frames, lut = _pad_video(
            self._prefilter(detections), metadatas, self.max_dets,
            self.n_frame_bucket, self.device)
        _, out = self._scan_fn()(self._make_config(), dets)
        return self._emissions_to_df(out, n_frames, lut)


class OCSORT(_ScanTrackerBase):
    """OC-SORT wrapper; names and defaults of oc_sort.yaml."""

    # a detections-only step: fusable with a device detector into one
    # program (engine/fused.py:run_fused_video)
    supports_fused_track = True

    def __init__(self, det_thresh: float = 0.4432, max_age: int = 50,
                 min_hits: int = 1, iou_threshold: float = 0.2214,
                 delta_t: int = 3, asso_func: str = "iou",
                 inertia: float = 0.3941, use_byte: bool = False,
                 max_tracks: int = 128, max_dets: int = 64,
                 min_confidence: float = 0.0, device=None, **kwargs):
        super().__init__(max_dets=max_dets, device=device, **kwargs)
        self.params = dict(
            det_thresh=det_thresh, max_age=max_age, min_hits=min_hits,
            iou_threshold=iou_threshold, delta_t=delta_t,
            asso_func=asso_func, inertia=inertia, use_byte=use_byte,
            max_tracks=max_tracks, max_dets=max_dets)
        self.min_confidence = min_confidence

    def _make_config(self):
        from tracklab_torch.trackers.ocsort import OCSortConfig
        return OCSortConfig(**self.params)

    def _scan_fn(self):
        from tracklab_torch.trackers.ocsort import ocsort_scan
        return ocsort_scan

    def _init_state(self, cfg):
        from tracklab_torch.trackers.ocsort import ocsort_init
        return ocsort_init(cfg, device=self.device)

    def _step_fn(self):
        from tracklab_torch.trackers.ocsort import ocsort_step
        return ocsort_step


class ByteTrack(_ScanTrackerBase):
    """ByteTrack wrapper; names and defaults of bytetrack.yaml."""

    supports_fused_track = True

    def __init__(self, track_thresh: float = 0.6,
                 match_thresh: float = 0.8, track_buffer: int = 25,
                 frame_rate: int = 30, min_confidence: float = 0.0,
                 max_tracks: int = 128, max_dets: int = 64, device=None,
                 **kwargs):
        super().__init__(max_dets=max_dets, device=device, **kwargs)
        self.min_confidence = min_confidence
        self.params = dict(
            track_thresh=track_thresh, match_thresh=match_thresh,
            track_buffer=track_buffer, frame_rate=frame_rate,
            max_tracks=max_tracks, max_dets=max_dets)

    def _make_config(self):
        from tracklab_torch.trackers.bytetrack import ByteTrackConfig
        return ByteTrackConfig(**self.params)

    def _scan_fn(self):
        from tracklab_torch.trackers.bytetrack import bytetrack_scan
        return bytetrack_scan

    def _init_state(self, cfg):
        from tracklab_torch.trackers.bytetrack import bytetrack_init
        return bytetrack_init(cfg, device=self.device)

    def _step_fn(self):
        from tracklab_torch.trackers.bytetrack import bytetrack_step
        return bytetrack_step
