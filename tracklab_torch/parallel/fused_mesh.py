"""The fused detector -> tracker programs over many cards (counterpart of
tracklab_tpu.parallel.fused_mesh).

``engine/fused.py`` runs detector -> NMS -> tracker (and the ReID, pose and
parts variants) over a whole video on one card. Here V videos are split
over a mesh axis: each rank takes its contiguous V / n videos and runs the
whole fused program on each, one after the other (the JAX package's
``lax.map`` within a shard), with no communication on the hot path; the
outputs, stacked on a leading video axis, are all-gathered to (V, ...) on
every rank. Each builder returns ``run(frames, frame_valid=None)`` over
(V, F, H, W, 3) frames; ``frame_valid`` (V, F) defaults to all-True, and V
must be a multiple of the axis size.
"""
from __future__ import annotations

import torch

from tracklab_torch.engine.fused import (fused_bottomup_track,
                                         fused_detect_parts_track,
                                         fused_detect_pose_track,
                                         fused_detect_reid_track,
                                         fused_detect_track)
from tracklab_torch.parallel.mesh import (gather_videos, mesh_axis,
                                          mesh_device, stack_trees)

__all__ = ["fused_videos_sharded", "fused_reid_videos_sharded",
           "fused_pose_videos_sharded", "fused_parts_videos_sharded",
           "fused_bottomup_videos_sharded"]


def _sharded_runner(one_video, mesh, axis: str):
    """The scaffolding of every builder: check V against the axis, give
    this rank its videos, run them one after the other on its device,
    stack and all-gather the outputs."""
    group, n, r = mesh_axis(mesh, axis)
    dev = mesh_device(mesh)

    def run(frames, frame_valid=None):
        V = frames.shape[0]
        if V % n:
            raise ValueError(
                f"V ({V}) must be a multiple of mesh.shape[{axis!r}] "
                f"({n}); pad with all-False frame_valid videos")
        if frame_valid is None:
            frame_valid = torch.ones(frames.shape[:2], dtype=torch.bool)
        k = V // n
        outs = [one_video(frames[v].to(dev), frame_valid[v].to(dev))
                for v in range(r * k, (r + 1) * k)]
        return gather_videos(stack_trees(outs), group, n)

    return run


def fused_videos_sharded(detect_fn, step_fn, init_state, mesh, chunk: int,
                         axis: str = "dp", return_detections: bool = False):
    """V videos through :func:`fused_detect_track` (detector -> NMS ->
    tracker) over ``mesh``'s ``axis``. Returns ``run(frames,
    frame_valid=None)`` giving ``(final_states, dets | None, outs)`` with
    leading (V, ...) axes."""
    def one_video(frames, frame_valid):
        return fused_detect_track(detect_fn, step_fn, init_state, frames,
                                  chunk, frame_valid=frame_valid,
                                  return_detections=return_detections)

    return _sharded_runner(one_video, mesh, axis)


def fused_reid_videos_sharded(detect_fn, embed_fn, step_fn, init_state,
                              mesh, chunk: int, axis: str = "dp",
                              min_confidence: float = 0.0,
                              embed_dim: int | None = None,
                              return_detections: bool = False,
                              return_embeddings: bool = False):
    """V videos through :func:`fused_detect_reid_track` (detector -> NMS ->
    device crops -> ReID -> embedding tracker). ``run`` gives
    ``(final_states, dets | None, emb | None, outs)`` with leading (V, ...)
    axes."""
    def one_video(frames, frame_valid):
        return fused_detect_reid_track(
            detect_fn, embed_fn, step_fn, init_state, frames, chunk,
            frame_valid=frame_valid, min_confidence=min_confidence,
            embed_dim=embed_dim, return_detections=return_detections,
            return_embeddings=return_embeddings)

    return _sharded_runner(one_video, mesh, axis)


def fused_pose_videos_sharded(detect_fn, pose_fn, step_fn, init_state,
                              mesh, chunk: int, axis: str = "dp",
                              min_confidence: float = 0.0,
                              pose_buckets=None,
                              return_detections: bool = False):
    """V videos through :func:`fused_detect_pose_track` (detector -> NMS ->
    device crops -> top-down pose -> tracker). ``run`` gives
    ``(final_states, dets | None, keypoints (V, F, D, K, 3), outs)``."""
    def one_video(frames, frame_valid):
        return fused_detect_pose_track(
            detect_fn, pose_fn, step_fn, init_state, frames, chunk,
            frame_valid=frame_valid, min_confidence=min_confidence,
            pose_buckets=pose_buckets,
            return_detections=return_detections)

    return _sharded_runner(one_video, mesh, axis)


def fused_parts_videos_sharded(detect_fn, embed_fn, step_fn, init_state,
                               mesh, chunk: int, axis: str = "dp",
                               min_confidence: float = 0.0,
                               n_parts: int = 5, embed_dim: int = 512,
                               n_keypoints: int = 17, pose_fn=None,
                               embed_buckets=None,
                               return_detections: bool = False,
                               return_embeddings: bool = False):
    """V videos through :func:`fused_detect_parts_track` (detector -> NMS
    -> device crops [-> top-down pose] -> KPR parts -> BPBReID-StrongSORT).
    ``run`` gives ``(final_states, dets | None, reid | None, kp | None,
    outs)`` with leading (V, ...) axes."""
    def one_video(frames, frame_valid):
        return fused_detect_parts_track(
            detect_fn, embed_fn, step_fn, init_state, frames, chunk,
            frame_valid=frame_valid, min_confidence=min_confidence,
            n_parts=n_parts, embed_dim=embed_dim, n_keypoints=n_keypoints,
            pose_fn=pose_fn, embed_buckets=embed_buckets,
            return_detections=return_detections,
            return_embeddings=return_embeddings)

    return _sharded_runner(one_video, mesh, axis)


def fused_bottomup_videos_sharded(detect_fn, step_fn, init_state, mesh,
                                  chunk: int, axis: str = "dp",
                                  min_confidence: float = 0.0,
                                  return_detections: bool = False):
    """V videos through :func:`fused_bottomup_track` (a bottom-up pose
    model's boxes and keypoints -> tracker). ``run`` gives
    ``(final_states, dets | None, keypoints, outs)``."""
    def one_video(frames, frame_valid):
        return fused_bottomup_track(
            detect_fn, step_fn, init_state, frames, chunk,
            frame_valid=frame_valid, min_confidence=min_confidence,
            return_detections=return_detections)

    return _sharded_runner(one_video, mesh, axis)
