"""The time axis of one video split over a mesh axis (counterpart of
tracklab_tpu.parallel.time_shard).

The only computation over neighbouring frames in the pipeline is the
camera warp between a frame and the one before it; the rest is per frame
(detector, pose, ReID) or a tracker scan that stays on one card. So:

* :func:`frames_time_sharded`: each rank runs a per-frame function over
  its contiguous F / n frames, with no communication;
* :func:`gmc_warps_time_sharded`: each rank estimates the LK warps of its
  frames (``motion/lk.py:gmc_warps``) and needs one halo frame, the last
  frame of the rank before it, passed around a ring (the JAX package's
  ``ppermute``); global frame 0's warp is the identity.

Outputs are all-gathered to (F, ...) on every rank. F must be a multiple of
the axis size.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from tracklab_torch.motion.lk import gmc_warps
from tracklab_torch.parallel.mesh import (gather_videos, mesh_axis,
                                          mesh_device, stack_trees)

__all__ = ["frames_time_sharded", "gmc_warps_time_sharded"]


def _local_frames(frames, n, r, axis, dev):
    F = frames.shape[0]
    if F % n:
        raise ValueError(f"F ({F}) must be a multiple of "
                         f"mesh.shape[{axis!r}] ({n})")
    k = F // n
    return frames[r * k:(r + 1) * k].to(dev)


def frames_time_sharded(per_frame_fn, mesh, axis: str = "dp"):
    """``run(frames)``: ``per_frame_fn`` on each frame of a (F, ...) stack,
    each rank taking its contiguous F / n frames; the per-frame outputs,
    stacked, all-gathered to (F, ...) on every rank."""
    group, n, r = mesh_axis(mesh, axis)
    dev = mesh_device(mesh)

    def run(frames):
        local = _local_frames(frames, n, r, axis, dev)
        return gather_videos(stack_trees([per_frame_fn(f) for f in local]),
                             group, n)

    return run


def _from_previous_rank(last, group, n, r):
    """The ring's halo: rank r sends its ``last`` frame to rank r + 1 and
    receives rank r - 1's (rank 0 receives rank n - 1's)."""
    if n == 1:
        return last
    halo = torch.empty_like(last)
    ops = [dist.P2POp(dist.isend, last.contiguous(),
                      dist.get_global_rank(group, (r + 1) % n), group),
           dist.P2POp(dist.irecv, halo,
                      dist.get_global_rank(group, (r - 1) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return halo


def gmc_warps_time_sharded(mesh, axis: str = "dp", levels: int = 3,
                           iters: int = 10):
    """``run(frames)``: (F, H, W[, 3]) -> (F, 2, 3) f32 LK camera warps with
    the time axis split over ``mesh``'s ``axis``; ``warp[t]`` maps frame t
    - 1 coords to frame t coords and ``warp[0]`` is the identity. Each rank
    takes F / n consecutive frames; the pair across a shard boundary takes
    the previous rank's last frame (one exchange around the ring)."""
    group, n, r = mesh_axis(mesh, axis)
    dev = mesh_device(mesh)

    def run(frames):
        local = _local_frames(frames, n, r, axis, dev)
        halo = _from_previous_rank(local[-1], group, n, r)
        warps = gmc_warps(local, levels, iters, prev=halo)
        if r == 0:
            warps[0] = torch.eye(2, 3, dtype=warps.dtype, device=dev)
        return gather_videos(warps, group, n)

    return run
