"""The port's multi-device layer (``parallel/``) on the CPU, against its
own unsharded runs and the JAX package's sharded ones.

World size 1, in this process on gloo (a one-rank group from an in-process
store, destroyed in the fixture's teardown): ``make_mesh``'s shapes and
limits; ``tracker_videos_sharded`` over ``ocsort_scan_videos`` on eight
seeded streams, equal id for id to the per-video ``ocsort_scan`` and to the
JAX package's ``tracker_videos_sharded`` on its 8-device virtual mesh (one
video a device); ``fused_videos_sharded`` (YOLOX-nano 64 x 64 -> NMS ->
OC-SORT) equal to per-video ``fused_detect_track`` runs; the LK warps of
``gmc_warps_time_sharded`` equal to ``gmc_warps`` and within 1e-3 of the
JAX package's on its 8-device mesh (halo exchanges included).

World size 2, two ranks spawned with ``torch.multiprocessing`` on gloo
(``tests/torch_parallel_worker.py``): ``tracker_videos_sharded``, the
time-sharded warps across the halo, ``frames_time_sharded``,
``shard_params_tp`` and ``shard_batch_dp`` equal their world-size-1
results; a V that is not a multiple of the axis raises ValueError.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_ocsort import CFG_KW, synth_stream
from test_torch_motion import _panning_video
from tracklab_tpu.parallel.mesh import make_mesh as jmake_mesh
from tracklab_tpu.parallel.mesh import \
    tracker_videos_sharded as jtracker_videos_sharded
from tracklab_tpu.parallel.time_shard import \
    gmc_warps_time_sharded as jgmc_warps_time_sharded
from tracklab_tpu.trackers import common as JC
from tracklab_tpu.trackers import ocsort as JO
from tracklab_torch.engine.fused import (fused_detect_track,
                                         make_yolox_detect_fn)
from tracklab_torch.models.yolox import YOLOX
from tracklab_torch.motion.lk import gmc_warps
from tracklab_torch.parallel.fused_mesh import fused_videos_sharded
from tracklab_torch.parallel.mesh import (make_mesh, release_process_group,
                                          shard_batch_dp, shard_params_tp,
                                          tracker_videos_sharded)
from tracklab_torch.parallel.time_shard import (frames_time_sharded,
                                                gmc_warps_time_sharded)
from tracklab_torch.trackers import common as TC
from tracklab_torch.trackers import ocsort as TO

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

V, F, T, D = 8, 24, 16, 8
CFG = dict(max_tracks=T, max_dets=D, **CFG_KW)


@pytest.fixture(scope="module")
def group():
    """The world-size-1 gloo group (made by ``make_mesh``), destroyed at
    the end so that nothing leaks into the next test module."""
    yield make_mesh(1, ("video", "unused"), tp_size=1, device="cpu")
    release_process_group()
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def streams():
    """(V, F, D) float64 padded detections of 8 seeded streams."""
    vids = []
    for v in range(V):
        per = [JC.pad_detections(f[:, :4], f[:, 4], f[:, 5],
                                 f[:, 6].astype(int), capacity=D,
                                 dtype=np.float64)
               for f in synth_stream(30 + v, n_frames=F, n_obj=4)]
        vids.append([np.stack([np.asarray(getattr(d, n)) for d in per])
                     for n in JC.Detections._fields])
    return [np.stack(x) for x in zip(*vids)]


@pytest.fixture(scope="module")
def world1(group, streams):
    """The world-size-1 results the world-size-2 ranks are held to."""
    dets = TC.Detections(*map(torch.from_numpy, streams))
    _, out = tracker_videos_sharded(TO.ocsort_scan_videos,
                                    TO.OCSortConfig(**CFG), group,
                                    axis="video")(dets)
    frames = torch.from_numpy(_panning_video(n=8))
    return dict(dets=dets, out=out, frames=frames,
                warps=gmc_warps_time_sharded(group, axis="video")(frames))


def _assert_tracks(got, want):
    """valid, track_id and ref equal; boxes within 1e-4 (float64 runs)."""
    valid = np.asarray(want.valid)
    assert valid.any()
    np.testing.assert_array_equal(np.asarray(got.valid), valid)
    for name in ("track_id", "ref"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name))[valid],
                                      np.asarray(getattr(want, name))[valid])
    np.testing.assert_allclose(np.asarray(got.ltrb)[valid],
                               np.asarray(want.ltrb)[valid], rtol=1e-5,
                               atol=1e-4)


def test_make_mesh_shapes_and_limits(group):
    """JAX's tp rule over the one rank; more devices than ranks raise."""
    mesh = make_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("dp", "tp") and tuple(mesh.shape) \
        == (1, 1)
    assert tuple(group.shape) == (1, 1) and group.mesh_dim_names == (
        "video", "unused")
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    with pytest.raises(ValueError, match="2 devices"):
        make_mesh(2, device="cpu")


def test_tracker_videos_sharded_matches_per_video_and_jax(world1, streams):
    """Eight videos through ``ocsort_scan_videos`` on the video mesh: each
    equal to its own ``ocsort_scan`` and to JAX's ``tracker_videos_sharded``
    on 8 virtual devices (one video a device), id for id."""
    out = world1["out"]
    assert out.valid.shape == (V, F, T)
    cfg = TO.OCSortConfig(**CFG)
    for v in range(V):
        _, one = TO.ocsort_scan(cfg, TC.Detections(
            *(x[v] for x in world1["dets"])))
        _assert_tracks(type(out)(*(x[v] for x in out)), one)
    jmesh = jmake_mesh(8, axis_names=("video", "unused"), tp_size=1)
    run = jtracker_videos_sharded(
        lambda c, d: JO.ocsort_scan(c, d), JO.OCSortConfig(**CFG), jmesh,
        axis="video")
    _, want = run(JC.Detections(*map(jnp.asarray, streams)))
    _assert_tracks(out, type(want)(*(np.asarray(x) for x in want)))


def test_fused_videos_sharded_equals_per_video_runs(group):
    """YOLOX-nano 64 x 64 (seeded) -> NMS -> OC-SORT over 2 videos of 4
    frames on the video mesh: each video's detections and tracks equal its
    own ``fused_detect_track``; frame_valid defaults to all-True."""
    model = YOLOX(num_classes=1, variant="nano", device="cpu").randomize_(0)
    detect = make_yolox_detect_fn(model, conf_threshold=0.2, max_dets=D)
    cfg = TO.OCSortConfig(**dict(CFG, det_thresh=0.2))
    step, init = partial(TO.ocsort_step, cfg), TO.ocsort_init(cfg,
                                                              device="cpu")
    g = torch.Generator().manual_seed(3)
    videos = torch.randint(0, 256, (2, 4, 64, 64, 3), generator=g,
                           dtype=torch.uint8)
    run = fused_videos_sharded(detect, step, init, group, chunk=2,
                               axis="video", return_detections=True)
    states, dets, outs = run(videos)
    assert outs.valid.shape == (2, 4, T) and dets.valid.shape == (2, 4, D)
    assert dets.valid.any()
    for v in range(2):
        st, d1, o1 = fused_detect_track(detect, step, init, videos[v], 2)
        _assert_tracks(type(outs)(*(x[v] for x in outs)), o1)
        for a, b in zip(dets, d1):
            assert torch.equal(a[v], b)
        for a, b in zip(states, st):
            assert torch.equal(a[v], b)


def test_gmc_warps_time_sharded_matches_gmc_warps_and_jax(world1):
    """8 frames of a panning texture: the time-sharded warps equal
    ``gmc_warps`` (warp 0 the identity) and lie within 1e-3 of the JAX
    package's on its 8-device mesh, where every pair but the first crosses
    a shard boundary through the halo."""
    frames, got = world1["frames"], world1["warps"]
    assert torch.equal(got, gmc_warps(frames))
    assert torch.equal(got[0], torch.eye(2, 3))
    want = jgmc_warps_time_sharded(jmake_mesh(8, tp_size=1))(
        jnp.asarray(frames.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


@pytest.fixture(scope="module")
def world2(world1, tmp_path_factory):
    """Two spawned gloo ranks on the world-size-1 inputs; each saves what
    it got."""
    import torch.multiprocessing as mp

    import torch_parallel_worker

    root = tmp_path_factory.mktemp("world2")
    g = torch.Generator().manual_seed(5)
    inputs = dict(cfg=CFG, dets=tuple(world1["dets"]),
                  frames=world1["frames"],
                  params={"conv": torch.randn(64, 8, 3, 3, generator=g),
                          "narrow": torch.randn(32, 8, generator=g),
                          "odd": torch.randn(65, 4, generator=g),
                          "bias": torch.randn(64, generator=g)},
                  batch={"images": torch.randn(4, 3, 8, 8, generator=g)})
    torch.save(inputs, root / "inputs.pt")
    mp.spawn(torch_parallel_worker.run,
             args=(2, str(root / "store"), str(root / "inputs.pt"),
                   str(root)),
             nprocs=2, join=True)
    return inputs, [torch.load(root / f"rank{r}.pt") for r in range(2)]


def test_world2_tracker_and_warps_equal_world1(world1, world2):
    """Each rank gathers all 8 videos' emissions equal to world size 1's,
    the warps across the halo (frame 4's pair spans the two ranks) and
    ``frames_time_sharded``'s per-frame outputs too; a batch of 3 videos
    raises ValueError on 2 ranks."""
    _, ranks = world2
    want = world1["out"]._asdict()
    for res in ranks:
        assert set(res["out"]) == {k for k, v in want.items()
                                   if torch.is_tensor(v)}
        for k, v in res["out"].items():
            # bit for bit (free slots hold NaN boxes in both)
            torch.testing.assert_close(v, want[k], rtol=0, atol=0,
                                       equal_nan=True, msg=k)
        np.testing.assert_allclose(res["warps"].numpy(),
                                   world1["warps"].numpy(), rtol=0,
                                   atol=1e-6)
        assert torch.equal(res["affine"], world1["frames"].float() * 2 + 1)
        assert "multiple of mesh.shape['video'] (2)" in res["ragged_tracker"]
        assert "multiple of mesh.shape['video'] (2)" in res["ragged_fused"]


def test_world2_shard_params_tp_and_batch_dp(world2):
    """(dp 1, tp 2): weights of >= 64 output channels that divide by 2 are
    split on dim 0 over tp, the rest replicated; (dp 2, tp 1): the batch's
    leading axis split over dp. Every rank's full tensors are the inputs;
    its local shards are its halves."""
    inputs, ranks = world2
    for r, res in enumerate(ranks):
        assert res["tp_shape"] == (1, 2)
        for k, full in inputs["params"].items():
            assert torch.equal(res["params_full"][k], full), k
            split = k in ("conv",)
            assert ("Shard(dim=0)" in res["params_placements"][k]) == split
            want = full.chunk(2)[r] if split else full
            assert torch.equal(res["params_local"][k], want), k
        x = inputs["batch"]["images"]
        assert torch.equal(res["batch_full"]["images"], x)
        assert torch.equal(res["batch_local"]["images"], x.chunk(2)[r])
