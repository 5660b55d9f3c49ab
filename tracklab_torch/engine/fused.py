"""Fused detector -> NMS -> tracker paths over a whole video (counterpart
of tracklab_tpu.engine.fused).

Three paths: detect -> NMS -> track (:func:`make_yolox_detect_fn`,
:func:`fused_detect_track`, :func:`fused_detect_track_concat`, and
:func:`run_fused_video`, the offline engine's fused branch, which drives it
from the detector and tracker modules and emits their DataFrames); the ReID
path, detect -> NMS -> device crops -> OSNet embeddings -> an embedding
tracker, StrongSORT, Deep-OC-SORT or BoT-SORT, with optional camera warps
(e.g. from ``motion/lk.py:gmc_warps``) (:func:`make_osnet_embed_fn`,
:func:`fused_detect_reid_track`, and :func:`run_fused_reid_video`, the
offline engine's 3-module branch); and the promptless KPR parts path,
detect -> NMS -> device crops -> KPR part features -> BPBReID-StrongSORT
(:func:`make_kpr_embed_fn`, :func:`fused_detect_parts_track`). By default
both crop paths embed every detection slot and issue no host sync; with
``embed_buckets`` they embed only the live slot prefix
(:func:`_bucketed_embed`), which reads the live count on the host once per
chunk.

The JAX package runs the video as one program: a ``lax.scan`` over frame
chunks whose body runs the batched detector (and the ReID model), then the
tracker's per-frame scan. Here the chunk scan is a Python loop over chunks
and, inside it, a loop over frames that carries the tracker state.
Detections stay on the device between the stages; boxes can be
unletterboxed on the device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tracklab_torch.models.kpr import (extract_test_embeddings,
                                       gaussian_prompt_maps)
from tracklab_torch.models.preprocess import (IMAGENET_MEAN, IMAGENET_STD,
                                              crop_resize)
from tracklab_torch.ops.nms import postprocess_detections
from tracklab_torch.trackers.common import (Detections, concat_resets,
                                            reset_wrapped_step, stack_frames)

__all__ = ["make_yolox_detect_fn", "fused_detect_track",
           "fused_detect_track_concat", "run_fused_video",
           "make_osnet_embed_fn", "fused_detect_reid_track",
           "run_fused_reid_video",
           "make_kpr_embed_fn", "fused_detect_parts_track"]


def make_yolox_detect_fn(model, conf_threshold: float = 0.4,
                         iou_threshold: float = 0.65, max_dets: int = 32,
                         compute_dtype=torch.float32):
    """Build ``detect_fn(frames, meta) -> Detections`` for a YOLOX model
    (``predict`` gives decoded (B, A, 5+C) maps from raw 0-255 input).

    ``frames``: (B, H, W, 3) uint8, cast to ``compute_dtype`` on the device.
    ``meta``: optional per-frame letterbox dict with ``scale`` (B,), ``pad``
    (B, 2) [left, top] and ``shape`` (B, 2) [w0, h0]; when given, boxes are
    mapped to original-image coordinates with the host wrapper's order of
    operations (unletterbox, clip, drop collapsed boxes).
    """

    def detect(frames, meta=None) -> Detections:
        imgs = frames.to(compute_dtype)
        with torch.no_grad():
            decoded = model.predict(imgs)
            d = postprocess_detections(decoded, conf_threshold=conf_threshold,
                                       iou_threshold=iou_threshold,
                                       max_out=max_dets)
        ltrb = d["ltrb"].float()
        valid = d["valid"]
        if meta is not None:
            scale = meta["scale"][:, None, None].float()
            pad = meta["pad"][:, None, :].float()
            wh0 = meta["shape"][:, None, :].float()
            zero = torch.zeros((), device=ltrb.device)
            lo = torch.minimum(torch.maximum((ltrb[..., 0:2] - pad) / scale,
                                             zero), wh0)
            hi = torch.minimum(torch.maximum((ltrb[..., 2:4] - pad) / scale,
                                             zero), wh0)
            ltrb = torch.cat([lo, hi], dim=-1)
            side = hi - lo
            valid = valid & (side[..., 0] > 0) & (side[..., 1] > 0)
        B = ltrb.shape[0]
        ref = torch.arange(max_dets, dtype=torch.int32,
                           device=ltrb.device).expand(B, max_dets)
        return Detections(ltrb, d["score"].float(), d["cls"].float(), ref,
                          valid)

    return detect


def fused_detect_track(detect_fn, step_fn, init_state, frames, chunk: int,
                       meta=None, frame_valid=None, reset=None,
                       return_detections: bool = True):
    """Run detector + tracker over a whole video.

    Args:
      detect_fn: ``(frames_chunk, meta_chunk | None) -> Detections`` with a
        leading chunk axis (e.g. from :func:`make_yolox_detect_fn`).
      step_fn: tracker step ``(state, Detections) -> (state, out)`` (e.g.
        ``partial(ocsort_step, cfg)``).
      init_state: tracker state for frame 0.
      frames: (F, H, W, 3) with ``F % chunk == 0``.
      chunk: detector batch size.
      meta: optional dict of per-frame letterbox tensors, leading axis F.
      frame_valid: optional (F,) bool, False for padded tail frames: their
        detections are masked out and the tracker still steps.
      reset: optional (F,) bool, True where the tracker state re-initializes
        (each video's first frame in a time-concatenated stream).
      return_detections: also return the per-frame Detections.

    Returns ``(final_state, dets | None, outs)`` with leading axis F.
    Detection refs are video-global: frame * D + slot.
    """
    F = frames.shape[0]
    if F % chunk:
        raise ValueError(f"frames ({F}) must be a multiple of chunk "
                         f"({chunk}); pad with frame_valid=False")
    step = step_fn if reset is None else reset_wrapped_step(step_fn,
                                                            init_state)
    state, outs, all_dets = init_state, [], []
    for base in range(0, F, chunk):
        sl = slice(base, base + chunk)
        dets = _detect_chunk(detect_fn, frames, sl, meta, frame_valid)
        for f in range(chunk):
            d = Detections(*(x[f] for x in dets))
            inp = d if reset is None else (d, reset[base + f])
            state, out = step(state, inp)
            outs.append(out)
        if return_detections:
            all_dets.append(dets)
    outs = stack_frames(outs)
    if not return_detections:
        return state, None, outs
    dets = Detections(*(torch.cat(f) for f in zip(*all_dets)))
    return state, dets, outs


def fused_detect_track_concat(detect_fn, step_fn, init_state, videos,
                              chunk: int, meta=None, frame_valid=None,
                              return_detections: bool = True):
    """Run V videos through :func:`fused_detect_track` as one
    time-concatenated stream with the tracker state reset at each video's
    first frame. Per-video tracker outputs equal V separate runs; detection
    refs are stream-global ((v * F + f) * D + slot).

    videos: (V, F, H, W, 3) with ``(V * F) % chunk == 0``; meta and
    frame_valid have leading (V, F) axes. Returns ``(final_state, dets,
    outs)`` with leading (V, F) axes; the state is the last video's.
    """
    V, F = videos.shape[0], videos.shape[1]

    def cat(x):
        return x.reshape((V * F,) + x.shape[2:])

    final, dets, outs = fused_detect_track(
        detect_fn, step_fn, init_state, cat(videos), chunk,
        meta=None if meta is None else {k: cat(v) for k, v in meta.items()},
        frame_valid=None if frame_valid is None else cat(frame_valid),
        reset=concat_resets(V, F, videos.device),
        return_detections=return_detections)

    def split(x):
        return x.reshape((V, F) + x.shape[1:])

    outs = type(outs)(*(split(x) for x in outs))
    if return_detections:
        dets = Detections(*(split(x) for x in dets))
    return final, dets, outs


def _collect_frames(detector, loader):
    """Drain the detector's loader on the host: (frame_ids, images (F, H, W,
    3) uint8, letterbox meta dict, F0 real frames, chunk, frame_valid), the
    frames padded to a multiple of the detector's batch size (padded
    frames: zero images, meta of ones, frame_valid False)."""
    import numpy as np

    frame_ids, imgs, metas = [], [], {"scale": [], "pad": [], "shape": []}
    for ids, samples in loader:
        frame_ids.extend(np.asarray(ids).tolist())
        imgs.append(np.asarray(samples["image"]))
        for k, v in metas.items():
            v.append(np.asarray(samples[k], np.float32))
    if not frame_ids:
        return [], None, None, 0, 0, None
    images = np.concatenate(imgs)
    meta = {k: np.concatenate(v) for k, v in metas.items()}
    F0 = len(frame_ids)
    chunk = min(max(int(getattr(detector, "batch_size", 8)), 1), F0)
    pad_n = -(-F0 // chunk) * chunk - F0
    if pad_n:
        images = np.concatenate(
            [images, np.zeros((pad_n,) + images.shape[1:], images.dtype)])
        meta = {k: np.concatenate([v, np.ones((pad_n,) + v.shape[1:],
                                              v.dtype)])
                for k, v in meta.items()}
    return frame_ids, images, meta, F0, chunk, np.arange(F0 + pad_n) < F0


def _detector_df(detector, dets, frame_ids, metadatas, F0, F_pad):
    """The fused run's detections -> the detector module's output rows,
    with the staged run's row ids (``detector.id`` counts on), and the lut
    from a detection's ref (frame * D + slot) to its row id (-1 where the
    slot holds no row). Read back from the card once."""
    import numpy as np

    D = dets.valid.shape[1]
    valid, ltrb, score, cls = (x[:F0].cpu().numpy() for x in
                               (dets.valid, dets.ltrb, dets.conf, dets.cls))
    fs, ds = np.nonzero(valid)
    lt = ltrb[fs, ds, 0:2]
    rows = detector._rows(metadatas.loc[frame_ids[:F0]], fs, lt,
                          ltrb[fs, ds, 2:4] - lt, cls[fs, ds],
                          score[fs, ds])
    lut = np.full(F_pad * D, -1, np.int64)
    lut[fs * D + ds] = rows.index.to_numpy()
    return rows, lut


def _staged_boxes(ltrb):
    """ltrb after the staged path's round trip through ltwh (right = left +
    width in f32, within an ulp of the detector's right): what a module
    that reads the detector's ``bbox_ltwh`` rows sees."""
    lt = ltrb[..., 0:2]
    return torch.cat([lt, lt + (ltrb[..., 2:4] - lt)], dim=-1)


def run_fused_video(detector, tracker, loader, metadatas):
    """One video through the fused path: drain the detector's loader (host
    threads decode and letterbox), run detector -> NMS -> device
    unletterbox -> tracker as one device program with no host sync per
    frame (:func:`fused_detect_track`), read it back once and emit both
    modules' DataFrames with the staged run's rows, row ids and columns.
    The tracker wrapper's pre-filter (bbox_conf > min_confidence) is a mask
    on the NMS output, and the tracker's boxes take the staged path's
    round trip through ltwh. Returns ``(detector_df, tracker_df)``."""
    import pandas as pd

    frame_ids, images, meta, F0, chunk, frame_valid = _collect_frames(
        detector, loader)
    if not frame_ids:
        return pd.DataFrame(), pd.DataFrame()
    detect_fn = detector.device_detect_fn()
    D = detector.max_dets
    cfg = tracker._make_config()
    trk_D = cfg.max_dets
    base_step = tracker._step_fn()
    min_conf = float(getattr(tracker, "min_confidence", 0.0))

    def step(state, det):
        if trk_D < D:
            det = Detections(*(x[:trk_D] for x in det))
        # the staged tracker reads the detector's rows: its class is
        # category_id (the class index + class_offset; OC-SORT scales its
        # velocity cost by it) and its boxes come back from bbox_ltwh
        # (right = left + width in f32, within an ulp of the detector's
        # right); the same here gives both paths equal tracker inputs
        det = det._replace(
            ltrb=_staged_boxes(det.ltrb),
            cls=det.cls + detector.class_offset,
            valid=det.valid & (det.conf > min_conf))
        return base_step(cfg, state, det)

    dev = detector.device
    _, dets, outs = fused_detect_track(
        detect_fn, step, tracker._init_state(cfg),
        torch.from_numpy(images).to(dev), chunk,
        meta={k: torch.from_numpy(v).to(dev) for k, v in meta.items()},
        frame_valid=torch.from_numpy(frame_valid).to(dev))
    det_df, lut = _detector_df(detector, dets, frame_ids, metadatas, F0,
                               len(frame_valid))
    trk_df = tracker._emissions_to_df(outs, F0, lut)
    return det_df, trk_df[trk_df.index >= 0]


def run_fused_reid_video(detector, reid, tracker, loader, metadatas):
    """One video through the fused ReID path: drain the detector's loader
    (host threads decode and letterbox), run detector -> NMS -> device
    unletterbox -> device crops -> ReID -> embedding tracker as one device
    program with no host sync (:func:`fused_detect_reid_track`), read it
    back once and emit the three modules' DataFrames with the staged run's
    rows, row ids and columns (the ReID rows by the ReID module's
    ``_rows``, as its ``process`` gives them).

    The crops come from the detector's letterboxed frames; the staged
    module crops its own work image, the same pixels when the work size
    equals the detector's input and the frame size. As in
    :func:`run_fused_video`, the ReID crops and the tracker take the boxes
    the staged modules read back from ``bbox_ltwh`` and the tracker's class
    is ``category_id`` (the class index + ``class_offset``). Camera warps
    come from the ``gmc_warp`` image column when a camera-motion module
    filled it (identity otherwise, or with the tracker's ``cmc_off``).
    Returns ``(detector_df, reid_df, tracker_df)``."""
    import numpy as np
    import pandas as pd

    frame_ids, images, meta, F0, chunk, frame_valid = _collect_frames(
        detector, loader)
    if not frame_ids:
        return pd.DataFrame(), pd.DataFrame(), pd.DataFrame()
    F_pad = len(frame_valid)
    detect_fn = detector.device_detect_fn()
    crop_meta = detector.crop_meta(meta)
    base_embed = reid.device_embed_fn()
    D = detector.max_dets
    cfg = tracker._make_config()
    trk_D = cfg.max_dets
    base_step = tracker._step_fn()
    min_conf = float(getattr(tracker, "min_confidence", 0.0))
    embed_dim = int(getattr(tracker, "embed_dim", 512))

    warps = np.broadcast_to(np.eye(2, 3, dtype=np.float32),
                            (F_pad, 2, 3)).copy()
    if ("gmc_warp" in metadatas.columns
            and not getattr(tracker, "cmc_off", False)):
        for f, fid in enumerate(frame_ids):
            w = metadatas.loc[fid, "gmc_warp"]
            if isinstance(w, np.ndarray) and w.shape == (2, 3):
                warps[f] = w

    def embed(frames, boxes):
        return base_embed(frames, _staged_boxes(boxes))

    def step(state, inputs):
        det, emb, warp = inputs
        if trk_D < D:
            det = Detections(*(x[:trk_D] for x in det))
            emb = emb[:trk_D]
        det = det._replace(ltrb=_staged_boxes(det.ltrb),
                           cls=det.cls + detector.class_offset)
        return base_step(cfg, state, (det, emb, warp))

    dev = detector.device

    def up(a):
        return torch.from_numpy(a).to(dev)

    _, dets, reid_out, outs = fused_detect_reid_track(
        detect_fn, embed, step, tracker._init_state(cfg), up(images), chunk,
        meta={k: up(v) for k, v in meta.items()},
        crop_meta={k: up(v) for k, v in crop_meta.items()},
        warps=up(warps), frame_valid=up(frame_valid),
        min_confidence=min_conf, embed_dim=embed_dim,
        embed_buckets=getattr(reid, "embed_buckets", None),
        return_embeddings=True)
    det_df, lut = _detector_df(detector, dets, frame_ids, metadatas, F0,
                               F_pad)
    reid_df = reid._rows(reid_out, lut.reshape(F_pad, D),
                         np.nonzero(dets.valid[:F0].cpu().numpy()))
    trk_df = tracker._emissions_to_df(outs, F0, lut)
    return det_df, reid_df, trk_df[trk_df.index >= 0]


def _detect_chunk(detect_fn, frames, sl, meta, frame_valid):
    """The detections of the chunk of frames ``sl``, with video-global
    refs (frame * D + slot) and the slots of padded frames
    (``frame_valid`` False) masked out."""
    m = None if meta is None else {k: v[sl] for k, v in meta.items()}
    dets = detect_fn(frames[sl], m)
    B, D = dets.ref.shape
    dev = dets.ref.device
    frame_idx = sl.start + torch.arange(B, dtype=torch.int32, device=dev)
    dets = dets._replace(
        ref=frame_idx[:, None] * D
        + torch.arange(D, dtype=torch.int32, device=dev)[None, :])
    if frame_valid is not None:
        dets = dets._replace(valid=dets.valid & frame_valid[sl][:, None])
    return dets


def _crop_stage(stage_fn, frames, dets, sl, crop_meta, embed_buckets):
    """``stage_fn(frames, boxes)`` on the chunk ``sl``'s detections, with
    boxes mapped into frame pixels by ``crop_meta`` (``frame_xy = out_xy *
    scale + pad``), over every slot or, with ``embed_buckets``, over the
    live prefix (:func:`_bucketed_embed`)."""
    boxes = dets.ltrb
    if crop_meta is not None:
        s = crop_meta["scale"][sl][:, None, :]
        p = crop_meta["pad"][sl][:, None, :]
        boxes = torch.cat([boxes[..., 0:2] * s + p,
                           boxes[..., 2:4] * s + p], dim=-1)
    if embed_buckets is not None:
        return _bucketed_embed(stage_fn, frames[sl], boxes, dets.valid,
                               tuple(embed_buckets))
    return stage_fn(frames[sl], boxes)


def _mask_slots(reid, valid):
    """Zero every ReID output of an invalid slot, as the staged ReID module
    emits rows only for valid detections."""
    return {k: v * valid.reshape(valid.shape + (1,) * (v.dim() - 2))
            for k, v in reid.items()}


def _imagenet_consts(consts, dev):
    """(mean, std) as f32 tensors on ``dev``, built once per device in
    ``consts``: a tensor made from Python numbers on the card is a
    host-to-device copy, which waits for the stream."""
    if dev not in consts:
        consts[dev] = tuple(torch.tensor(c, dtype=torch.float32, device=dev)
                            for c in (IMAGENET_MEAN, IMAGENET_STD))
    return consts[dev]


def make_osnet_embed_fn(model, crop_size=(256, 128),
                        compute_dtype=torch.float32):
    """Build ``embed_fn(frames, boxes) -> dict`` for an OSNet-family ReID
    model (``models.osnet.OSNet``): crop-and-resize every detection slot on
    the device (:func:`crop_resize`), ImageNet-normalise, one batched
    forward, as the staged batched ReID module does with the detector's
    frames as the work image.

    ``frames`` (B, H, W, 3) uint8, ``boxes`` (B, D, 4) ltrb in frame
    coordinates. Returns f32 ``embeddings`` (B, D, E), ``part_features``
    (B, D, P + 1, E') and ``visibility`` (B, D, P + 1). The normalisation
    constants are put on the model's device here, so that a program that
    calls ``embed_fn`` makes no host-to-device copy."""
    ch, cw = crop_size
    consts = {}
    _imagenet_consts(consts, next(model.parameters()).device)

    def embed(frames, boxes):
        mean, std = _imagenet_consts(consts, frames.device)
        crops = crop_resize(frames, boxes, ch, cw)      # (B, D, ch, cw, 3)
        B, D = crops.shape[0], crops.shape[1]
        x = ((crops.reshape(B * D, ch, cw, 3) - mean) / std).to(
            compute_dtype)
        out = model(x)
        res = {"embeddings": out["embeddings"].float().reshape(B, D, -1)}
        if "part_features" in out:
            pf = out["part_features"].float()
            res["part_features"] = pf.reshape(B, D, pf.shape[1], -1)
            res["visibility"] = out["visibility"].float().reshape(B, D, -1)
        return res

    return embed


def fused_detect_reid_track(detect_fn, embed_fn, step_fn, init_state,
                            frames, chunk: int, meta=None, crop_meta=None,
                            warps=None, frame_valid=None,
                            min_confidence: float = 0.0,
                            embed_dim: int | None = None,
                            embed_buckets=None,
                            return_detections: bool = True,
                            return_embeddings: bool = False):
    """Detector -> NMS -> device crops -> ReID embeddings -> embedding
    tracker over a whole video (the reference's BASELINE config-2 pipeline,
    e.g. YOLOX + OSNet + StrongSORT, Deep-OC-SORT or BoT-SORT).

    Args:
      detect_fn: ``(frames_chunk, meta_chunk | None) -> Detections``.
      embed_fn: ``(frames_chunk, boxes (B, D, 4)) -> dict`` with
        ``embeddings`` (B, D, E) (:func:`make_osnet_embed_fn`); crops come
        from the detector's own input frames.
      step_fn: tracker step ``(state, (Detections, emb (D, E), warp (2,
        3))) -> (state, out)``: ``partial(strongsort_step, cfg)``,
        ``partial(deepocsort_step, cfg)`` or ``partial(botsort_step,
        cfg)``.
      crop_meta: optional ``{"scale": (F, 2), "pad": (F, 2)}`` mapping
        detector-output boxes into frame pixels for cropping, ``frame_xy =
        out_xy * scale + pad``; identity when None.
      warps: optional (F, 2, 3) camera warps, ``warps[t]`` mapping frame
        t - 1 to frame t (``motion/lk.py:gmc_warps``); identity when None.
      frame_valid: optional (F,) bool, False for padded tail frames.
      min_confidence: the tracker wrapper's pre-filter (``conf >
        min_confidence``) as a mask; NMS slots are score-descending, so the
        mask equals the staged row drop.
      embed_dim: the tracker's embedding width; the ReID output is cut or
        zero-padded to it.
      embed_buckets: optional ascending widths (the last equal to max_dets)
        for the live-prefix compaction of the ReID stage
        (:func:`_bucketed_embed`). It reads the live count on the host: one
        host sync per chunk. None (the default) embeds every slot with no
        host sync.

    Returns ``(final_state, dets | None, reid | None, outs)`` with a
    leading frame axis F; ``reid`` is the full ReID output dict when
    ``return_embeddings``. Detection refs are video-global: frame * D +
    slot.
    """
    F_ = frames.shape[0]
    if F_ % chunk:
        raise ValueError(f"frames ({F_}) must be a multiple of chunk "
                         f"({chunk}); pad with frame_valid=False")
    state, outs, all_dets, all_reid = init_state, [], [], []
    for base in range(0, F_, chunk):
        sl = slice(base, base + chunk)
        dets = _detect_chunk(detect_fn, frames, sl, meta, frame_valid)
        dev = dets.ref.device
        reid = _mask_slots(_crop_stage(embed_fn, frames, dets, sl, crop_meta,
                                       embed_buckets), dets.valid)
        emb = reid["embeddings"]
        if embed_dim is not None and emb.shape[-1] != embed_dim:
            emb = emb[..., :embed_dim]
            emb = F.pad(emb, (0, embed_dim - emb.shape[-1]))

        trk_dets = dets._replace(
            valid=dets.valid & (dets.conf > min_confidence))
        emb = emb * trk_dets.valid[..., None]
        warp = (torch.eye(2, 3, dtype=torch.float32, device=dev).expand(
            chunk, 2, 3) if warps is None else warps[sl])
        for f in range(chunk):
            state, out = step_fn(state, (
                Detections(*(x[f] for x in trk_dets)), emb[f], warp[f]))
            outs.append(out)
        if return_detections:
            all_dets.append(dets)
        if return_embeddings:
            all_reid.append(reid)

    outs = stack_frames(outs)
    dets = (Detections(*(torch.cat(f) for f in zip(*all_dets)))
            if return_detections else None)
    reid = ({k: torch.cat([r[k] for r in all_reid]) for k in all_reid[0]}
            if return_embeddings else None)
    return state, dets, reid, outs


def make_kpr_embed_fn(model, crop_size=(384, 128), n_prompt_ch: int = 6,
                      test_embeddings=("bn_foreg", "parts"),
                      binary_visibility: bool = True,
                      vis_thresh: float = 0.3,
                      compute_dtype=torch.float32):
    """Build ``embed_fn(frames, boxes, keypoints=None) -> dict`` for a KPR
    model (``models.kpr.KPR``): crop-and-resize every detection slot on the
    device, ImageNet-normalise, one batched forward. With ``keypoints``
    (B, D, K, 3) in the frame of ``boxes`` the cck6 gaussian prompt maps
    are drawn on the device; without them the prompts are zero
    (``n_prompt_ch`` channels).

    ``frames`` (B, H, W, 3), ``boxes`` (B, D, 4). Returns ``embeddings``
    (B, D, P', E) and ``visibility`` (B, D, P'), both f32, in the
    test-embeddings part layout (:func:`extract_test_embeddings`)."""
    ch, cw = crop_size
    consts = {}

    def embed(frames, boxes, keypoints=None):
        dev = frames.device
        mean, std = _imagenet_consts(consts, dev)
        crops = crop_resize(frames, boxes, ch, cw)      # (B, D, ch, cw, 3)
        B, D = crops.shape[0], crops.shape[1]
        x = ((crops.reshape(B * D, ch, cw, 3) - mean) / std).to(
            compute_dtype)
        if keypoints is None:
            prompts = torch.zeros((B * D, ch, cw, n_prompt_ch),
                                  dtype=compute_dtype, device=dev)
        else:
            prompts = gaussian_prompt_maps(keypoints, boxes, (ch, cw),
                                           vis_thresh=vis_thresh)
            prompts = prompts.reshape(B * D, ch, cw, -1).to(compute_dtype)
        out = model(x, prompts)
        emb, vis = extract_test_embeddings(out, test_embeddings,
                                           binary_visibility)
        return {"embeddings": emb.float().reshape(B, D, emb.shape[1], -1),
                "visibility": vis.float().reshape(B, D, -1)}

    return embed


def _bucketed_embed(embed_fn, frames, boxes, valid, buckets):
    """Run ``embed_fn`` on only the live slot prefix of the chunk, at the
    smallest width of ``buckets`` (ascending, last == D) that covers the
    chunk's largest live count, and zero-pad the outputs back to D. NMS
    slots are score-descending, so ``valid`` is a prefix per frame.

    The JAX package picks the width with ``lax.switch`` on the device; here
    the live count is read on the host: one host sync per chunk, which
    stalls the host until the card drains. Leave ``embed_buckets`` None for
    a sync-free path (every slot embedded)."""
    D = boxes.shape[1]
    if not buckets or buckets[-1] != D or list(buckets) != sorted(buckets):
        raise ValueError(
            f"embed_buckets must be ascending and end at max_dets "
            f"({D}); got {buckets}")
    d_live = int(valid.sum(dim=1).max())              # the host sync
    d_eff = next(b for b in buckets if b >= d_live)
    return _pad_slots(embed_fn(frames, boxes[:, :d_eff]), D)


def _pad_slots(x, D):
    """Zero-pad axis 1 (detection slots) of every tensor of a nested dict
    to D."""
    if isinstance(x, dict):
        return {k: _pad_slots(v, D) for k, v in x.items()}
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, D - x.shape[1]))


def fused_detect_parts_track(detect_fn, embed_fn, step_fn, init_state,
                             frames, chunk: int, meta=None, crop_meta=None,
                             warps=None, frame_valid=None,
                             min_confidence: float = 0.0, n_parts: int = 5,
                             embed_dim: int = 512, n_keypoints: int = 17,
                             pose_fn=None, embed_buckets=None,
                             return_detections: bool = True,
                             return_embeddings: bool = False):
    """Detector -> NMS -> device crops [-> top-down pose] -> KPR part
    features -> BPBReID-StrongSORT over a whole video.

    ``step_fn`` is the part-based tracker step ``(state, (Detections, feat
    (D, P, E), vis (D, P), kps (D, K, 3), warp (2, 3))) -> (state, out)``
    (``partial(bpbreid_step, cfg)``). The ReID output's part layout
    (P', E') is cut or zero-padded to the tracker's (``n_parts``,
    ``embed_dim``). ``pose_fn(frames, boxes) -> (B, D, K, 3)`` keypoints,
    when given, prompt the ReID model, feed the tracker's OKS motion input
    in original-image coordinates and are returned; without it prompts and
    tracker keypoints are zero. ``min_confidence`` (applied only when > 0)
    masks the tracker's detections. ``embed_buckets``: optional live-prefix
    widths for the pose + ReID stage (:func:`_bucketed_embed`, which reads
    the live count on the host once per chunk; None embeds every slot with
    no host sync).
    ``crop_meta`` (``scale`` (F, 2), ``pad`` (F, 2)) maps boxes from the
    original image into ``frames``; ``warps`` (F, 2, 3) are camera warps.

    Returns ``(final_state, dets | None, reid | None, kp | None, outs)``
    with a leading frame axis F.
    """
    F_ = frames.shape[0]
    if F_ % chunk:
        raise ValueError(f"frames ({F_}) must be a multiple of chunk "
                         f"({chunk}); pad with frame_valid=False")
    state, outs = init_state, []
    all_dets, all_reid, all_kp = [], [], []

    # prompts are crop-relative: frame-coordinate keypoints and boxes give
    # the same maps as the original-coordinate pair
    def stage(f, bx):
        if pose_fn is None:
            return {"reid": embed_fn(f, bx)}
        kpf = pose_fn(f, bx)
        return {"reid": embed_fn(f, bx, kpf), "kp": kpf}

    for base in range(0, F_, chunk):
        sl = slice(base, base + chunk)
        dets = _detect_chunk(detect_fn, frames, sl, meta, frame_valid)
        D = dets.ref.shape[1]
        dev = dets.ref.device
        st_out = _crop_stage(stage, frames, dets, sl, crop_meta,
                             embed_buckets)
        reid, kp_frame = st_out["reid"], st_out.get("kp")

        kp_orig = None
        if kp_frame is not None:
            kp_orig = kp_frame
            if crop_meta is not None:
                s = crop_meta["scale"][sl][:, None, None, :]
                p = crop_meta["pad"][sl][:, None, None, :]
                kp_orig = torch.cat([(kp_frame[..., 0:2] - p) / s,
                                     kp_frame[..., 2:3]], dim=-1)
            kp_orig = kp_orig * dets.valid[..., None, None]
        reid = _mask_slots(reid, dets.valid)
        emb, vis = reid["embeddings"], reid["visibility"]

        # part-layout fit: cut to (P, E), zero-pad the rest
        P, E = n_parts, embed_dim
        feat = emb[:, :, :P, :E]
        feat = F.pad(feat, (0, E - feat.shape[3], 0, P - feat.shape[2]))
        visf = vis[:, :, :P]
        visf = F.pad(visf, (0, P - visf.shape[2]))

        trk_dets = dets
        if min_confidence > 0:
            trk_dets = dets._replace(
                valid=dets.valid & (dets.conf > min_confidence))
        feat = feat * trk_dets.valid[..., None, None]
        visf = visf * trk_dets.valid[..., None]
        if kp_orig is None:
            kps = torch.zeros((chunk, D, n_keypoints, 3),
                              dtype=torch.float32, device=dev)
        else:
            kps = kp_orig[:, :, :n_keypoints]
            kps = F.pad(kps, (0, 0, 0, n_keypoints - kps.shape[2]))
            kps = kps * trk_dets.valid[..., None, None]
        warp = (torch.eye(2, 3, dtype=torch.float32, device=dev).expand(
            chunk, 2, 3) if warps is None else warps[sl])
        for f in range(chunk):
            state, out = step_fn(state, (
                Detections(*(x[f] for x in trk_dets)), feat[f], visf[f],
                kps[f], warp[f]))
            outs.append(out)
        if return_detections:
            all_dets.append(dets)
        if return_embeddings:
            all_reid.append(reid)
        if kp_orig is not None:
            all_kp.append(kp_orig)

    outs = stack_frames(outs)
    dets = (Detections(*(torch.cat(f) for f in zip(*all_dets)))
            if return_detections else None)
    reid = ({k: torch.cat([r[k] for r in all_reid]) for k in all_reid[0]}
            if return_embeddings else None)
    kp = torch.cat(all_kp) if all_kp else None
    return state, dets, reid, kp, outs

