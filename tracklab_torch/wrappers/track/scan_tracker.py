"""Tracker wrappers: the DataFrame boundary around the port's scan trackers
(counterpart of tracklab_tpu.wrappers.track.scan_tracker).

A tracker is a VideoLevelModule: each video's detections are padded into
fixed-capacity tensors once (:func:`_pad_video`), the scan runs on the
module's device, its emissions are read back once and joined onto the
detection rows by row id (columns track_id, track_bbox_ltwh,
track_bbox_conf). The embedding trackers (StrongSORT, BoT-SORT,
Deep-OC-SORT) also take each row's ``embeddings`` and each frame's camera
warp (the ``gmc_warp`` image column, or StrongSORT's own ECC).

The scan is written over a leading video axis:

* multi-video (``process_video_batch``, the batched engine): V videos are
  padded to one frame bucket, stacked on the video axis and stepped
  together, one ``*_scan_videos`` step per frame for all of them (the JAX
  package time-concatenates them into one scan instead, for the TPU's
  ``lax.cond`` costs, which the card does not have); ``process`` is its
  V = 1 case;
* streaming (``process_online``, the online engine): one step per frame
  with the state kept on the device until ``reset()``; refs stay unique
  across the stream, so a coasting track's stale ref still finds its row.
  The frame's inputs go up without a host sync (pinned, non-blocking) and
  its emissions come back in one readback, the mode's one sync per frame.
"""
from __future__ import annotations

import logging
from types import SimpleNamespace

import numpy as np
import pandas as pd
import torch

from tracklab_torch.device import resolve_device
from tracklab_torch.pipeline.levels import VideoLevelModule
from tracklab_torch.trackers.common import Detections, pad_detections

log = logging.getLogger(__name__)

__all__ = ["OCSORT", "ByteTrack", "StrongSORT", "BotSORT", "DeepOCSORT",
           "BPBReIDStrongSORT"]


def _upload(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A host tensor on ``dev`` without a host sync: on CUDA through pinned
    memory and a non-blocking copy."""
    if dev.type != "cuda":
        return x.to(dev)
    return x.pin_memory().to(dev, non_blocking=True)


def _move(inputs, dev):
    """Scan inputs (each a Detections or a tensor) moved to ``dev``."""
    return [Detections(*(f.to(dev) for f in x))
            if isinstance(x, Detections) else x.to(dev) for x in inputs]


def _stack_videos(per_video):
    """Per-video scan inputs (each a Detections or a tensor) stacked on a
    new leading video axis."""
    return [Detections(*(torch.stack(f) for f in zip(*parts)))
            if isinstance(parts[0], Detections) else torch.stack(parts)
            for parts in zip(*per_video)]


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
        self.reset()

    def reset(self):
        """Start a new stream: the next ``process_online`` begins a video
        with a fresh tracker state."""
        self._online_state = None
        self._online_lut = {}
        self._online_next_ref = 0
        self._ecc_gmc = None
        self._ecc_prev = None

    def _prefilter(self, detections: pd.DataFrame) -> pd.DataFrame:
        if len(detections):
            return detections[detections["bbox_conf"] > self.min_confidence]
        return detections

    def _make_config(self):
        raise NotImplementedError

    def _scan_videos_fn(self):
        raise NotImplementedError

    def _init_state(self, cfg):
        raise NotImplementedError

    def _step_fn(self):
        raise NotImplementedError

    def _video_inputs(self, detections, metadatas, n_frame_bucket):
        """One video's scan inputs on the host (after the pre-filter), its
        number of real frames and its ref lut."""
        dets, n_frames, lut = _pad_video(
            self._prefilter(detections), metadatas, self.max_dets,
            n_frame_bucket, device="cpu")
        return (dets,), n_frames, lut

    @staticmethod
    def _emissions_to_df(out, n_frames, lut):
        """A scan's emissions (leading frame axis; tensors on any device or
        numpy arrays) -> the output rows. A coasting track re-emits the ref
        of its last match; the last emission of a row wins."""
        valid, track_id, ltrb, conf, ref = (
            np.asarray(x[:n_frames].cpu() if torch.is_tensor(x)
                       else x[:n_frames])
            for x in (out.valid, out.track_id, out.ltrb, out.conf, out.ref))
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
        """One video: the V = 1 case of :meth:`process_video_batch`."""
        if len(detections) == 0:
            return detections
        return self.process_video_batch([(detections, metadatas)])[0]

    # ------------------------------------------------------------------
    # multi-video mode (the batched engine)
    # ------------------------------------------------------------------
    def process_video_batch(self, items):
        """``items``: (detections, metadatas) of V videos. Every video is
        padded to the common frame bucket (the smallest multiple of
        ``n_frame_bucket`` that holds the longest), the V videos are
        stacked on a leading video axis and stepped together, one
        ``*_scan_videos`` step per frame in the tracker's configured mode,
        and the emissions are read back once. Returns each video's output
        rows, equal to its own ``process``."""
        if not items:
            return []
        longest = max(len(m) for _, m in items)
        bucket = max(-(-longest // self.n_frame_bucket)
                     * self.n_frame_bucket, self.n_frame_bucket)
        per_video = [self._video_inputs(d, m, bucket) for d, m in items]
        inputs = _move(_stack_videos([p[0] for p in per_video]),
                       self.device)
        _, out = self._scan_videos_fn()(self._make_config(), *inputs)
        host = {k: x.cpu().numpy() for k, x in out._asdict().items()
                if k in self._emitted and x is not None}
        return [self._video_rows(
                    SimpleNamespace(**{k: x[v] for k, x in host.items()}),
                    n, lut, inp)
                for v, (inp, n, lut) in enumerate(per_video)]

    # the emission fields ``process_video_batch`` reads back
    _emitted = ("valid", "track_id", "ltrb", "conf", "ref")

    def _video_rows(self, out, n_frames, lut, inputs):
        """One video's output rows from its host emissions (and its scan
        inputs, on the host)."""
        return self._emissions_to_df(out, n_frames, lut)

    # ------------------------------------------------------------------
    # streaming mode (the online engine)
    # ------------------------------------------------------------------
    def _truncate_frame(self, detections: pd.DataFrame) -> pd.DataFrame:
        """A frame with more than ``max_dets`` rows keeps its most
        confident ones, in confidence order: ``_pad_video``'s choice, so
        streaming equals offline across an overflow."""
        if len(detections) > self.max_dets:
            log.warning("frame has %d detections > capacity %d; keeping "
                        "the %d most confident", len(detections),
                        self.max_dets, self.max_dets)
            detections = detections.sort_values(
                "bbox_conf", ascending=False).head(self.max_dets)
        return detections

    def _pad_frame(self, detections: pd.DataFrame):
        """One frame's rows (already cut to ``max_dets``) -> Detections on
        the module's device and the stream's lut from ref to row id.

        Refs count up over the whole stream, so a coasting track's stale
        ref still names its row. A valid emission's ref is at most
        ``max_age`` frames old; refs older than that window are dropped
        from the lut, which bounds it on an endless stream."""
        window = (int(getattr(self._make_config(), "max_age", 100)) + 2) \
            * self.max_dets
        lut = self._online_lut
        n = len(detections)
        base = self._online_next_ref
        if n:
            for i, idx in enumerate(detections.index):
                lut[base + i] = idx
            self._online_next_ref = base + n
            if len(lut) > 2 * window:
                cutoff = self._online_next_ref - window
                for k in [k for k in lut if k < cutoff]:
                    del lut[k]
            boxes = np.stack(detections["bbox_ltwh"].to_numpy())
            cls = (pd.to_numeric(detections["category_id"], errors="coerce")
                   .fillna(1.0).to_numpy()
                   if "category_id" in detections else None)
            det = pad_detections(
                _ltwh_to_ltrb(boxes),
                detections["bbox_conf"].to_numpy(np.float32), cls,
                base + np.arange(n), capacity=self.max_dets, device="cpu")
        else:
            det = pad_detections(np.zeros((0, 4)), np.zeros(0),
                                 capacity=self.max_dets, device="cpu")
        return Detections(*(_upload(x, self.device) for x in det)), lut

    @staticmethod
    def _emit_online(out, lut) -> pd.DataFrame:
        """One frame's emissions -> output rows, read back in one copy."""
        host = torch.cat([out.ltrb.double()] + [
            x[:, None].double() for x in (out.track_id, out.conf, out.ref,
                                          out.valid)], 1).cpu().numpy()
        ltrb, track_id, conf = host[:, :4], host[:, 4], host[:, 5]
        ref, valid = host[:, 6].astype(np.int64), host[:, 7] > 0
        keep = [t for t in np.nonzero(valid)[0]
                if ref[t] >= 0 and ref[t] in lut]
        result = pd.DataFrame(index=[lut[ref[t]] for t in keep])
        result["track_id"] = track_id[keep]
        result["track_bbox_ltwh"] = list(
            _ltrb_to_ltwh(ltrb[keep].astype(np.float32)).astype(np.float32))
        result["track_bbox_conf"] = conf[keep]
        return result[~result.index.duplicated(keep="last")]

    def _online_inputs(self, rows, det, metadata):
        """The step's inputs for one frame."""
        return det

    def _online_rows(self, out, lut):
        """One frame's emissions -> its output rows."""
        return self._emit_online(out, lut)

    def process_online(self, detections: pd.DataFrame,
                       metadata: pd.Series) -> pd.DataFrame:
        """Track one frame, carrying the tracker state across calls until
        ``reset()``; returns the frame's output rows."""
        cfg = self._make_config()
        if self._online_state is None:
            self._online_state = self._init_state(cfg)
        rows = self._truncate_frame(self._prefilter(detections))
        det, lut = self._pad_frame(rows)
        self._online_state, out = self._step_fn()(
            cfg, self._online_state,
            self._online_inputs(rows, det, metadata))
        return self._online_rows(out, lut)


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

    def _scan_videos_fn(self):
        from tracklab_torch.trackers.ocsort import ocsort_scan_videos
        return ocsort_scan_videos

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

    def _scan_videos_fn(self):
        from tracklab_torch.trackers.bytetrack import bytetrack_scan_videos
        return bytetrack_scan_videos

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

    def _video_inputs(self, detections, metadatas, n_frame_bucket):
        dets_in = self._prefilter(detections)
        dets, n_frames, lut = _pad_video(dets_in, metadatas, self.max_dets,
                                         n_frame_bucket, device="cpu")
        F = dets.valid.shape[0]
        emb = _collect_embeddings(dets_in, dets, lut, n_frames,
                                  self.embed_dim)
        warps = self._video_warps(metadatas, n_frames, F)
        return ((dets, torch.from_numpy(emb), torch.from_numpy(warps)),
                n_frames, lut)

    def _online_emb(self, rows: pd.DataFrame):
        """(max_dets, E) embeddings of one frame's rows, in their order: a
        part layout gives its row 0; a row whose embedding is None stays
        zero."""
        emb = np.zeros((self.max_dets, self.embed_dim), np.float32)
        if len(rows) and "embeddings" in rows.columns:
            for i, e in enumerate(rows["embeddings"].to_numpy()
                                  [:self.max_dets]):
                if e is None:
                    continue
                e = np.asarray(e, np.float32)
                if e.ndim == 2:
                    e = e[0]
                emb[i, :min(len(e), self.embed_dim)] = e[:self.embed_dim]
        return emb

    def _online_warp(self, metadata):
        """One frame's camera warp, by ``_video_warps``'s policy: identity
        with ``cmc_off``; StrongSORT's own ECC against the previous frame of
        the stream when ``ecc`` is set and the frame has no ``gmc_warp``;
        else that column (identity where absent)."""
        eye = np.eye(2, 3, dtype=np.float32)
        if getattr(self, "cmc_off", False) or metadata is None:
            return eye
        w = metadata.get("gmc_warp")
        if isinstance(w, np.ndarray):
            return w.astype(np.float32) if w.shape == (2, 3) else eye
        if not getattr(self, "ecc", False):
            return eye
        from tracklab_torch.motion.gmc import GMC
        from tracklab_torch.utils.cv2 import cv2_load_image
        if self._ecc_gmc is None:
            self._ecc_gmc = GMC(method="ecc")
        img = cv2_load_image(metadata["file_path"])
        w = self._ecc_gmc.apply(self._ecc_prev, img)
        self._ecc_prev = img
        return np.asarray(w, np.float32)

    def _online_inputs(self, rows, det, metadata):
        return (det,
                _upload(torch.from_numpy(self._online_emb(rows)),
                        self.device),
                _upload(torch.from_numpy(self._online_warp(metadata)),
                        self.device))


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

    def _scan_videos_fn(self):
        from tracklab_torch.trackers.strongsort import strongsort_scan_videos
        return strongsort_scan_videos

    def _step_fn(self):
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

    def _scan_videos_fn(self):
        from tracklab_torch.trackers.botsort import botsort_scan_videos
        return botsort_scan_videos

    def _step_fn(self):
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

    def _scan_videos_fn(self):
        from tracklab_torch.trackers.deepocsort import deepocsort_scan_videos
        return deepocsort_scan_videos

    def _step_fn(self):
        from tracklab_torch.trackers.deepocsort import deepocsort_step
        return deepocsort_step

    def _init_state(self, cfg):
        from tracklab_torch.trackers.deepocsort import deepocsort_init
        return deepocsort_init(cfg, device=self.device)


def _part_inputs(dets_in, rows_of, P, E, K):
    """(N, P, E) part features, (N, P) visibilities and (N, K, 3) keypoints
    of the rows ``rows_of`` (row ids, -1 for none) of ``dets_in``: any
    (rows, E') part layout of ``embeddings`` is cut or zero-padded to
    (P, E) (OSNet gives the global feature and n_parts stripes; rows past P
    are dropped, missing ones stay zero, their visibility 0 masks them), a
    flat embedding is read as rows of E; ``visibility_scores`` and
    ``keypoints_xyc`` likewise; rows without them stay zero."""
    feat = np.zeros((len(rows_of), P, E), np.float32)
    vis = np.zeros((len(rows_of), P), np.float32)
    kps = np.zeros((len(rows_of), K, 3), np.float32)
    cols = [c for c in ("embeddings", "visibility_scores", "keypoints_xyc")
            if c in dets_in.columns]
    by_row = {c: dets_in[c].to_dict() for c in cols}
    for i, row in enumerate(rows_of):
        if row < 0:
            continue
        e = by_row.get("embeddings", {}).get(row)
        if e is not None:
            e = np.asarray(e, np.float32)
            e = e.reshape(-1, e.shape[-1]) if e.ndim > 1 else e.reshape(-1, E)
            r, c = min(e.shape[0], P), min(e.shape[1], E)
            feat[i, :r, :c] = e[:r, :c]
        v = by_row.get("visibility_scores", {}).get(row)
        if v is not None:
            v = np.asarray(v, np.float32)
            vis[i, :min(len(v), P)] = v[:P]
        k = by_row.get("keypoints_xyc", {}).get(row)
        if isinstance(k, np.ndarray):
            kps[i, :min(len(k), K)] = k[:K]
    return feat, vis, kps


class BPBReIDStrongSORT(_EmbScanTrackerBase):
    """BPBReID-StrongSORT wrapper: part-based ReID embeddings and their
    visibility scores (``OSNetReId`` parts, KPR), with the rows'
    ``keypoints_xyc`` for OKS motion; names and defaults of
    bpbreid_strong_sort.yaml's reference values. Output columns: the KF
    boxes and the track lifecycle counters (hits, age, time_since_update,
    state), plus ``matched_with`` and ``costs`` with ``emit_costs``.

    Its step takes (Detections, feat, vis, kps, warp), not the flat
    embedding tracker's 3 inputs, so the ReID fused branch does not drive
    it; the part-based fused paths do (``engine/fused.py``:
    ``run_fused_parts_video`` after a promptless KPR module,
    ``run_fused_gsr_video`` after top-down pose and a prompted one).
    ``process_video_batch`` steps V videos at once over the video axis
    (``bpbreid_scan_videos``, each equal to its own scan)."""

    input_columns = ["bbox_ltwh", "bbox_conf", "category_id",
                     "embeddings", "visibility_scores"]
    output_columns = ["track_id", "track_bbox_ltwh", "track_bbox_conf",
                      "track_bbox_kf_ltwh", "track_bbox_pred_kf_ltwh",
                      "hits", "age", "time_since_update", "state"]
    supports_fused_emb_track = False
    supports_fused_parts_track = True
    _emitted = ("valid", "track_id", "ltrb", "conf", "ref", "pred_ltrb",
                "tstate", "hits", "age", "time_since_update", "costs_r",
                "costs_s", "costs_k", "matched_stage", "matched_cost",
                "cost_track_valid", "cost_track_id")

    def __init__(self, max_dist: float = 0.5,
                 motion_criterium: str = "iou",
                 max_iou_distance: float = 0.8,
                 max_oks_distance: float = 0.7, max_age: int = 300,
                 n_init: int = 0, mc_lambda: float = 0.995,
                 ema_alpha: float = 0.9, only_position: bool = False,
                 n_parts: int = 6, embed_dim: int = 512,
                 n_keypoints: int = 17, min_confidence: float = 0.0,
                 emit_costs: bool = False, ecc: bool = False,
                 max_tracks: int = 128, max_dets: int = 64, device=None,
                 **kwargs):
        super().__init__(max_dets=max_dets, device=device, **kwargs)
        self.ecc = ecc
        self.params = dict(
            max_dist=max_dist, motion_criterium=motion_criterium,
            max_iou_distance=max_iou_distance,
            max_oks_distance=max_oks_distance, max_age=max_age,
            n_init=n_init, mc_lambda=mc_lambda, ema_alpha=ema_alpha,
            only_position=only_position, n_parts=n_parts,
            embed_dim=embed_dim, n_keypoints=n_keypoints,
            emit_costs=emit_costs, max_tracks=max_tracks, max_dets=max_dets)
        self.min_confidence = min_confidence
        self.emit_costs = emit_costs
        if emit_costs:
            # the instrumentation columns exist only when requested, so
            # Pipeline.validate stays truthful
            self.output_columns = self.output_columns + ["matched_with",
                                                         "costs"]
        self.n_parts, self.embed_dim = n_parts, embed_dim
        self.n_keypoints = n_keypoints

    def _make_config(self):
        from tracklab_torch.trackers.bpbreid_strongsort import \
            BPBReIDStrongSortConfig
        return BPBReIDStrongSortConfig(**self.params)

    def _scan_videos_fn(self):
        from tracklab_torch.trackers.bpbreid_strongsort import \
            bpbreid_scan_videos
        return bpbreid_scan_videos

    def _step_fn(self):
        from tracklab_torch.trackers.bpbreid_strongsort import bpbreid_step
        return bpbreid_step

    def _init_state(self, cfg):
        from tracklab_torch.trackers.bpbreid_strongsort import bpbreid_init
        return bpbreid_init(cfg, device=self.device)

    def _prefilter(self, detections):
        # the JAX wrapper filters only with a positive threshold
        if self.min_confidence > 0:
            return super()._prefilter(detections)
        return detections

    def _video_inputs(self, detections, metadatas, n_frame_bucket):
        dets_in = self._prefilter(detections)
        dets, n_frames, lut = _pad_video(dets_in, metadatas, self.max_dets,
                                         n_frame_bucket, device="cpu")
        F, D = dets.valid.shape
        ref, valid = dets.ref.numpy(), dets.valid.numpy()
        rows_of = np.full(ref.shape, -1, np.int64)
        rows_of[valid] = lut[ref[valid]]
        rows_of = rows_of.reshape(-1)
        feat, vis, kps = _part_inputs(dets_in, rows_of, self.n_parts,
                                      self.embed_dim, self.n_keypoints)
        warps = self._video_warps(metadatas, n_frames, F)
        P, E, K = self.n_parts, self.embed_dim, self.n_keypoints
        return ((dets, torch.from_numpy(feat.reshape(F, D, P, E)),
                 torch.from_numpy(vis.reshape(F, D, P)),
                 torch.from_numpy(kps.reshape(F, D, K, 3)),
                 torch.from_numpy(warps)), n_frames, lut)

    def _video_rows(self, out, n_frames, lut, inputs):
        return self._bpb_emissions_to_df(out, n_frames, lut, dets=inputs[0])

    def _online_inputs(self, rows, det, metadata):
        D = self.max_dets
        rows_of = np.full(D, -1, np.int64)
        rows_of[:len(rows)] = rows.index.to_numpy()[:D]
        feat, vis, kps = _part_inputs(rows, rows_of, self.n_parts,
                                      self.embed_dim, self.n_keypoints)
        warp = self._online_warp(metadata)
        return (det,) + tuple(_upload(torch.from_numpy(a), self.device)
                              for a in (feat, vis, kps, warp))

    def _online_rows(self, out, lut):
        """One frame's emissions, read back in one copy, -> its rows with
        the lifecycle columns."""
        cols = [out.ltrb, out.pred_ltrb] + [
            x[:, None] for x in (out.track_id, out.conf, out.ref, out.valid,
                                 out.tstate, out.hits, out.age,
                                 out.time_since_update)]
        host = torch.cat([c.double() for c in cols], 1).cpu().numpy()
        names = ("track_id", "conf", "ref", "valid", "tstate", "hits", "age",
                 "time_since_update")
        em = SimpleNamespace(ltrb=host[None, :, 0:4],
                             pred_ltrb=host[None, :, 4:8],
                             **{k: host[None, :, 8 + i]
                                for i, k in enumerate(names)})
        # the stream's refs -> positions in an array lut of their rows
        refs = np.fromiter(sorted(lut), np.int64, len(lut))
        ref = em.ref.astype(np.int64)
        pos = np.minimum(np.searchsorted(refs, ref), max(len(refs) - 1, 0))
        known = (ref >= 0) & (len(refs) > 0) & (refs[pos] == ref) \
            if len(refs) else np.zeros(ref.shape, bool)
        em.valid = (em.valid > 0) & known
        em.ref = np.where(known, pos, -1)
        rows = np.array([lut[k] for k in refs], np.int64)
        return self._bpb_emissions_to_df(em, 1, rows)

    def _bpb_emissions_to_df(self, out, n_frames, lut, dets=None):
        """Stacked per-frame emissions (numpy, leading frame axis) -> the
        wrapper's rows: the KF box (also as ``track_bbox_kf_ltwh``), the
        pre-update KF snapshot ``track_bbox_pred_kf_ltwh`` (NaN until a
        track's first update), the lifecycle counters and state, and with
        ``emit_costs`` and the consumed detections ``dets`` the per-row cost
        dicts to every live track and the matched stage and cost (the
        reference's sort/tracker.py instrumentation). The last emission of a
        row wins."""
        valid = np.asarray(out.valid[:n_frames]) & (
            np.asarray(out.ref[:n_frames]) >= 0)
        fs, ts = np.nonzero(valid)

        def at(x, dtype=None):
            a = np.asarray(x[:n_frames])[fs, ts]
            return a if dtype is None else a.astype(dtype)

        result = pd.DataFrame(index=lut[at(out.ref, np.int64)] if len(fs)
                              else np.zeros(0, int))
        result["track_id"] = at(out.track_id, float)
        kf_ltwh = _ltrb_to_ltwh(at(out.ltrb)).astype(np.float32)
        result["track_bbox_ltwh"] = list(kf_ltwh)
        result["track_bbox_kf_ltwh"] = list(kf_ltwh)
        result["track_bbox_pred_kf_ltwh"] = list(
            _ltrb_to_ltwh(at(out.pred_ltrb)).astype(np.float32))
        result["track_bbox_conf"] = at(out.conf, float)
        for k in ("tstate", "hits", "age", "time_since_update"):
            result["state" if k == "tstate" else k] = at(getattr(out, k),
                                                        np.int64)
        if self.emit_costs and getattr(out, "costs_r", None) is not None \
                and dets is not None:
            result["costs"], result["matched_with"] = self._cost_columns(
                out, n_frames, lut, dets, result.index)
        return result[~result.index.duplicated(keep="last")]

    def _cost_columns(self, out, n_frames, lut, dets, index):
        """Per row: the appearance (R), motion (S) and Mahalanobis (K) costs
        to every live track with their thresholds, and the matched stage
        ("R" or "S") and cost, or None."""
        p = self.params
        thr = dict(Rt=p["max_dist"],
                   St=(p["max_oks_distance"] if p["motion_criterium"] == "oks"
                       else p["max_iou_distance"]),
                   Kt=5.9915 if p["only_position"] else 9.4877)
        cr, cs, ck, stage, mcost, tvalid, tids = (
            np.asarray(getattr(out, k)[:n_frames]) for k in (
                "costs_r", "costs_s", "costs_k", "matched_stage",
                "matched_cost", "cost_track_valid", "cost_track_id"))
        ref, dvalid = np.asarray(dets.ref), np.asarray(dets.valid)
        costs, matched = {}, {}
        for f in range(n_frames):
            live = np.nonzero(tvalid[f])[0]
            ids = tids[f, live].tolist()
            for d in np.nonzero(dvalid[f])[0]:
                row = lut[ref[f, d]]
                costs[row] = {"R": dict(zip(ids, cr[f, d, live].tolist())),
                              "Rt": thr["Rt"],
                              "S": dict(zip(ids, cs[f, d, live].tolist())),
                              "St": thr["St"],
                              "K": dict(zip(ids, ck[f, d, live].tolist())),
                              "Kt": thr["Kt"]}
                st = int(stage[f, d])
                matched[row] = (("R" if st == 1 else "S",
                                 float(mcost[f, d])) if st else None)
        return (pd.Series(costs).reindex(index).to_numpy(),
                pd.Series(matched).reindex(index).to_numpy())
