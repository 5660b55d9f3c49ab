"""Fused detect -> NMS -> track over a whole video (counterpart of the main
path of tracklab_tpu.engine.fused).

The JAX package runs the video as one program: a ``lax.scan`` over frame
chunks whose body runs the batched detector, then the tracker's per-frame
scan. Here the chunk scan is a Python loop over chunks and, inside it, a
loop over frames that carries the tracker state. Detections stay on the
device between the stages; boxes can be unletterboxed on the device.
"""
from __future__ import annotations

import torch

from tracklab_torch.ops.nms import postprocess_detections
from tracklab_torch.trackers.common import (Detections, concat_resets,
                                            reset_wrapped_step, stack_frames)

__all__ = ["make_yolox_detect_fn", "fused_detect_track",
           "fused_detect_track_concat"]


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
        m = None if meta is None else {k: v[sl] for k, v in meta.items()}
        dets = detect_fn(frames[sl], m)
        D = dets.ref.shape[1]
        dev = dets.ref.device
        frame_idx = base + torch.arange(chunk, dtype=torch.int32, device=dev)
        dets = dets._replace(
            ref=frame_idx[:, None] * D
            + torch.arange(D, dtype=torch.int32, device=dev)[None, :])
        if frame_valid is not None:
            dets = dets._replace(valid=dets.valid & frame_valid[sl][:, None])
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
