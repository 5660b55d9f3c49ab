"""The world-size-2 worker of tests/test_torch_parallel.py: each spawned
rank joins a gloo process group through a ``file://`` store, runs the
port's sharded functions on the inputs the test saved, and saves what it
got for the test to hold against the world-size-1 runs. It imports nothing
of JAX or of the JAX package (the test module does, and a spawned child
imports only this one)."""
import os

import torch
import torch.distributed as dist


def _raises(fn, *args):
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    return None


def run(rank, world, init_file, inputs_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        from tracklab_torch.parallel.fused_mesh import fused_videos_sharded
        from tracklab_torch.parallel.mesh import (make_mesh,
                                                  shard_batch_dp,
                                                  shard_params_tp,
                                                  tracker_videos_sharded)
        from tracklab_torch.parallel.time_shard import (
            frames_time_sharded, gmc_warps_time_sharded)
        from tracklab_torch.trackers.common import Detections
        from tracklab_torch.trackers.ocsort import (OCSortConfig,
                                                    ocsort_scan_videos)

        d = torch.load(inputs_path)
        videos = make_mesh(world, ("video", "unused"), tp_size=1,
                           device="cpu")
        track = tracker_videos_sharded(ocsort_scan_videos,
                                       OCSortConfig(**d["cfg"]), videos,
                                       axis="video")
        dets = Detections(*d["dets"])
        _, out = track(dets)
        frames = d["frames"]
        warps = gmc_warps_time_sharded(videos, axis="video")(frames)
        affine = frames_time_sharded(lambda f: f.float() * 2 + 1, videos,
                                     axis="video")(frames)
        # (dp 1, tp 2): weights of >= 64 even output channels split on tp
        tp_mesh = make_mesh(device="cpu")
        params = shard_params_tp(d["params"], tp_mesh)
        # (dp 2, tp 1): the batch split on dp
        dp_mesh = make_mesh(world, tp_size=1, device="cpu")
        batch = shard_batch_dp(d["batch"], dp_mesh)
        result = {
            "tp_shape": tuple(tp_mesh.shape),
            "out": {k: v for k, v in out._asdict().items()
                    if torch.is_tensor(v)},
            "warps": warps, "affine": affine,
            "params_local": {k: v.to_local() for k, v in params.items()},
            "params_full": {k: v.full_tensor() for k, v in params.items()},
            "params_placements": {k: str(v.placements)
                                  for k, v in params.items()},
            "batch_local": {k: v.to_local() for k, v in batch.items()},
            "batch_full": {k: v.full_tensor() for k, v in batch.items()},
            "ragged_tracker": _raises(track, Detections(
                *(x[:3] for x in dets))),
            "ragged_fused": _raises(fused_videos_sharded(
                None, None, None, videos, chunk=2, axis="video"),
                torch.zeros((3, 2, 8, 8, 3), dtype=torch.uint8)),
        }
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
