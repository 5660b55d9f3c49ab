"""Tracker wrappers: the DataFrame boundary around the port's scan trackers
(counterpart of tracklab_tpu.wrappers.track.scan_tracker).

A tracker is a VideoLevelModule: the whole video's detections are padded
into fixed-capacity tensors once (:func:`_pad_video`), the scan runs on the
module's device, its emissions are read back once and joined onto the
detection rows by row id (columns track_id, track_bbox_ltwh,
track_bbox_conf). The embedding trackers (StrongSORT, BoT-SORT,
Deep-OC-SORT) also take each row's ``embeddings`` and each frame's camera
warp (the ``gmc_warp`` image column, or StrongSORT's own ECC). The JAX
package's streaming (``process_online``) and multi-video
(``process_video_batch``) modes wait for the video and batched engines.
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

__all__ = ["OCSORT", "ByteTrack", "StrongSORT", "BotSORT", "DeepOCSORT"]


def _ltwh_to_ltrb(b):
    b = np.asarray(b, np.float64)
    return np.concatenate([b[..., :2], b[..., :2] + b[..., 2:4]], axis=-1)


def _ltrb_to_ltwh(b):
    b = np.asarray(b, np.float64)
    return np.concatenate([b[..., :2], b[..., 2:4] - b[..., :2]], axis=-1)


def _collect_embeddings(dets_in, dets, lut, n_frames, embed_dim):
    """(F, D, E) f32 embeddings aligned with the padded detections ``dets``
    (fields on the CPU or numpy): each valid slot gets its row's
    ``embeddings``, cut or zero-padded to ``embed_dim``; a part layout
    (n_parts + 1, E) gives its row 0, the global feature. Rows without an
    embedding (None) stay zero."""
    ref, valid = (np.asarray(x) for x in (dets.ref, dets.valid))
    F, D = valid.shape
    emb = np.zeros((F, D, embed_dim), np.float32)
    if len(dets_in) and "embeddings" in dets_in.columns:
        by_row = {idx: e for idx, e in dets_in["embeddings"].items()
                  if e is not None}
        for f, d in zip(*np.nonzero(valid[:n_frames])):
            e = by_row.get(lut[ref[f, d]])
            if e is None:
                continue
            e = np.asarray(e, np.float32)
            if e.ndim == 2:
                e = e[0]
            emb[f, d, :min(len(e), embed_dim)] = e[:embed_dim]
    return emb


def _collect_warps(metadatas, n_frames, bucketed_frames):
    """(F, 2, 3) per-frame camera warps from the image-level ``gmc_warp``
    column (``motion/gmc.py:CameraMotion``); identity where absent."""
    warps = np.broadcast_to(np.eye(2, 3, dtype=np.float32),
                            (bucketed_frames, 2, 3)).copy()
    if "gmc_warp" in metadatas.columns:
        for f, w in enumerate(metadatas["gmc_warp"].to_numpy()[:n_frames]):
            if isinstance(w, np.ndarray) and w.shape == (2, 3):
                warps[f] = w
    return warps


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


class _EmbScanTrackerBase(_ScanTrackerBase):
    """The embedding trackers' wrapper: each row's ``embeddings`` and each
    frame's camera warp go into the scan beside the padded detections; the
    emissions are joined back by row (the last emission of a row wins)."""

    input_columns = ["bbox_ltwh", "bbox_conf", "category_id", "embeddings"]
    output_columns = ["track_id", "track_bbox_ltwh", "track_bbox_conf"]
    # a (Detections, emb, warp) step: fusable with a device detector and
    # device-crop ReID into one program (engine/fused.py:
    # run_fused_reid_video)
    supports_fused_emb_track = True

    embed_dim = 512

    def _scan3(self):
        raise NotImplementedError

    def _step3(self):
        raise NotImplementedError

    def _video_warps(self, metadatas, n_frames, bucketed_frames):
        """The wrapper's warp policy: identity with ``cmc_off``, else
        StrongSORT's own ECC when it is asked for and no camera-motion
        module filled ``gmc_warp``, else that column (identity where
        absent)."""
        if getattr(self, "cmc_off", False):
            return np.broadcast_to(np.eye(2, 3, dtype=np.float32),
                                   (bucketed_frames, 2, 3)).copy()
        w = self._maybe_ecc_warps(metadatas, n_frames, bucketed_frames)
        return w if w is not None else _collect_warps(
            metadatas, n_frames, bucketed_frames)

    def _maybe_ecc_warps(self, metadatas, n_frames, bucketed_frames):
        """ECC camera warps between consecutive frames (``GMC("ecc")`` on
        the host, frames loaded from ``file_path``), when ``ecc`` is set
        and no ``gmc_warp`` column exists; else None."""
        if not getattr(self, "ecc", False) \
                or "gmc_warp" in metadatas.columns:
            return None
        from tracklab_torch.motion.gmc import GMC
        from tracklab_torch.utils.cv2 import cv2_load_image
        g = GMC(method="ecc")
        warps = np.broadcast_to(np.eye(2, 3, dtype=np.float32),
                                (bucketed_frames, 2, 3)).copy()
        prev = None
        for f, path in enumerate(metadatas["file_path"].to_numpy()
                                 [:n_frames]):
            img = cv2_load_image(path)
            warps[f] = g.apply(prev, img)
            prev = img
        return warps

    def process(self, detections: pd.DataFrame,
                metadatas: pd.DataFrame) -> pd.DataFrame:
        if len(detections) == 0:
            return detections
        dets_in = self._prefilter(detections)
        dets, n_frames, lut = _pad_video(dets_in, metadatas, self.max_dets,
                                         self.n_frame_bucket, device="cpu")
        F = dets.valid.shape[0]
        emb = _collect_embeddings(dets_in, dets, lut, n_frames,
                                  self.embed_dim)
        warps = self._video_warps(metadatas, n_frames, F)
        dev = self.device
        _, out = self._scan3()(
            self._make_config(), Detections(*(x.to(dev) for x in dets)),
            torch.from_numpy(emb).to(dev), torch.from_numpy(warps).to(dev))
        return self._emissions_to_df(out, n_frames, lut)


class StrongSORT(_EmbScanTrackerBase):
    """StrongSORT wrapper; names and defaults of strong_sort.yaml."""

    def __init__(self, max_dist: float = 0.1594,
                 max_iou_dist: float = 0.5432, max_age: int = 40,
                 n_init: int = 3, nn_budget: int = 100,
                 mc_lambda: float = 0.995, ema_alpha: float = 0.8962,
                 embed_dim: int = 512, min_confidence: float = 0.4,
                 max_tracks: int = 128, max_dets: int = 64,
                 ecc: bool = False, device=None, **kwargs):
        super().__init__(max_dets=max_dets, device=device, **kwargs)
        self.params = dict(
            max_dist=max_dist, max_iou_dist=max_iou_dist, max_age=max_age,
            n_init=n_init, nn_budget=nn_budget, mc_lambda=mc_lambda,
            ema_alpha=ema_alpha, embed_dim=embed_dim,
            max_tracks=max_tracks, max_dets=max_dets)
        self.min_confidence = min_confidence
        self.ecc = ecc
        self.embed_dim = embed_dim

    def _make_config(self):
        from tracklab_torch.trackers.strongsort import StrongSortConfig
        return StrongSortConfig(**self.params)

    def _scan3(self):
        from tracklab_torch.trackers.strongsort import strongsort_scan
        return strongsort_scan

    def _step3(self):
        from tracklab_torch.trackers.strongsort import strongsort_step
        return strongsort_step

    def _init_state(self, cfg):
        from tracklab_torch.trackers.strongsort import strongsort_init
        return strongsort_init(cfg, device=self.device)


class BotSORT(_EmbScanTrackerBase):
    """BoT-SORT wrapper; names and defaults of bot_sort.yaml. Camera
    compensation comes from the camera-motion module's ``gmc_warp``
    column."""

    def __init__(self, track_high_thresh: float = 0.3382,
                 new_track_thresh: float = 0.2114, track_buffer: int = 60,
                 match_thresh: float = 0.2273,
                 proximity_thresh: float = 0.5945,
                 appearance_thresh: float = 0.4818,
                 lambda_: float = 0.9896, frame_rate: int = 30,
                 ema_alpha: float = 0.9, embed_dim: int = 512,
                 min_confidence: float = 0.4, max_tracks: int = 128,
                 max_dets: int = 64, device=None, **kwargs):
        super().__init__(max_dets=max_dets, device=device, **kwargs)
        self.params = dict(
            track_high_thresh=track_high_thresh,
            new_track_thresh=new_track_thresh, track_buffer=track_buffer,
            match_thresh=match_thresh, proximity_thresh=proximity_thresh,
            appearance_thresh=appearance_thresh, lambda_=lambda_,
            frame_rate=frame_rate, ema_alpha=ema_alpha,
            embed_dim=embed_dim, max_tracks=max_tracks, max_dets=max_dets)
        self.min_confidence = min_confidence
        self.embed_dim = embed_dim

    def _make_config(self):
        from tracklab_torch.trackers.botsort import BotSortConfig
        return BotSortConfig(**self.params)

    def _scan3(self):
        from tracklab_torch.trackers.botsort import botsort_scan
        return botsort_scan

    def _step3(self):
        from tracklab_torch.trackers.botsort import botsort_step
        return botsort_step

    def _init_state(self, cfg):
        from tracklab_torch.trackers.botsort import botsort_init
        return botsort_init(cfg, device=self.device)


class DeepOCSORT(_EmbScanTrackerBase):
    """Deep-OC-SORT wrapper; names and defaults of deep_oc_sort.yaml."""

    def __init__(self, det_thresh: float = 0.0, max_age: int = 50,
                 min_hits: int = 1, iou_threshold: float = 0.2214,
                 delta_t: int = 1, asso_func: str = "giou",
                 inertia: float = 0.3942,
                 w_association_emb: float = 0.75,
                 alpha_fixed_emb: float = 0.95, aw_param: float = 0.5,
                 embedding_off: bool = False, aw_off: bool = False,
                 cmc_off: bool = False, new_kf_off: bool = False,
                 embed_dim: int = 512, min_confidence: float = 0.4,
                 max_tracks: int = 128, max_dets: int = 64, device=None,
                 **kwargs):
        super().__init__(max_dets=max_dets, device=device, **kwargs)
        if new_kf_off:
            log.warning("DeepOCSORT: new_kf_off is not supported; the "
                        "tracker always uses the xywh dynamic-noise KF")
        self.params = dict(
            det_thresh=det_thresh, max_age=max_age, min_hits=min_hits,
            iou_threshold=iou_threshold, delta_t=delta_t,
            asso_func=asso_func, inertia=inertia,
            w_association_emb=w_association_emb,
            alpha_fixed_emb=alpha_fixed_emb, aw_param=aw_param,
            embedding_off=embedding_off, aw_off=aw_off,
            embed_dim=embed_dim, max_tracks=max_tracks,
            max_dets=max_dets)
        self.min_confidence = min_confidence
        self.embed_dim = embed_dim
        self.cmc_off = cmc_off

    def _make_config(self):
        from tracklab_torch.trackers.deepocsort import DeepOCSortConfig
        return DeepOCSortConfig(**self.params)

    def _scan3(self):
        from tracklab_torch.trackers.deepocsort import deepocsort_scan
        return deepocsort_scan

    def _step3(self):
        from tracklab_torch.trackers.deepocsort import deepocsort_step
        return deepocsort_step

    def _init_state(self, cfg):
        from tracklab_torch.trackers.deepocsort import deepocsort_init
        return deepocsort_init(cfg, device=self.device)
