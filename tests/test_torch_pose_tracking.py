"""The port's pose-tracking slice against the JAX package's on the CPU.

BASELINE config 3 as typed, ``+experiment=sportsmot_pose`` (bottom-up
YOLOXPose -> keypoint-prompted OSNet -> BPBReID-StrongSORT with OKS
motion), on a SportsMOT-layout tree of 2 x 8 PNG frames of 128 x 128 (the
letterbox is then the identity), with widths cut (YOLOXPose-nano, OSNet
x0_25 at 128 x 64, 32-d) against JAX's run, id for id; through the JAX
run's own module instances (their programs compiled once) the pieces:
``gaussian_keypoint_masks``, ``OSNetReId(use_keypoints=True)``,
``BottomUpPoseEstimator.process`` and ``BPBReIDStrongSORT.process`` with
OKS on a hand-made stream; then the port's fused paths against its staged
ones: bottom-up -> OC-SORT (tests/test_fused_engine.py's bounds) and
YOLOX -> ``TopDownPoseBatched`` -> OC-SORT (``run_fused_pose_video``).

The weights are seeded numpy draws on the flax trees' shapes (no init
program is compiled): lecun-normal kernels (the port's seeded draw for
these models), identity BN, zero biases; the JAX pose wrappers read a draw
through their ``checkpoint_path`` (``_jax_checkpoints`` hands it to their
``load_checkpoint``: an orbax write and restore take ~5 s), the port
from the ``*_from_flax`` state dict.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from tracklab_tpu import main as JM
from tracklab_tpu.config import compose as jcompose
from tracklab_tpu.models.osnet import OSNet as JOSNet
from tracklab_tpu.models.pose import YOLOXPose as JYOLOXPose
from tracklab_tpu.wrappers.reid import reid_dataset as JRD
from tracklab_torch import main as TM
from tracklab_torch.config import compose as tcompose
from tracklab_torch.models.convert import (osnet_from_flax,
                                           yoloxpose_from_flax)
from tracklab_torch.wrappers.pose_estimator import BottomUpPoseEstimator
from tracklab_torch.wrappers.reid import reid_dataset as TRD
from tracklab_torch.wrappers.track import BPBReIDStrongSORT

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

SIZE, N_FRAMES = 128, 8
CROP = (128, 64)
POSE = ["modules.pose_estimator.variant=nano",
        f"modules.pose_estimator.input_size=[{SIZE},{SIZE}]",
        "modules.pose_estimator.min_confidence=0.2965",
        "+modules.pose_estimator.max_dets=16",
        "modules.pose_estimator.batch_size=4"]
REID = ["modules.reid.variant=x0_25", "modules.reid.feat_dim=32",
        f"modules.reid.crop_size=[{CROP[0]},{CROP[1]}]",
        "modules.reid.batch_size=128"]
TRACK = ["modules.track.max_dets=16", "modules.track.max_tracks=32",
         "modules.track.embed_dim=32", "modules.track.n_init=1"]
ARGS = ["+experiment=sportsmot_pose", "use_rich=false", "num_cores=2"] \
    + POSE + REID + TRACK


def _lecun(jmodel, shape, seed):
    """Seeded flax variables of ``jmodel`` at an input of ``shape``:
    lecun-normal kernels, identity BN, zero biases."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros(shape, jnp.float32))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            return (rng.normal(0, 1, a.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if name in ("var", "scale"):
            return np.ones(a.shape, np.float32)
        return np.zeros(a.shape, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _sports_tree(root, n_videos=2, n_frames=N_FRAMES):
    """A SportsMOT-layout val split of PNG frames at 128 x 128: eight
    players (blocks of 12 x 28 px, a head on top) crossing a textured
    court, their boxes as gt.txt."""
    import cv2
    rng = np.random.default_rng(0)
    court = rng.integers(40, 110, (SIZE, SIZE, 3)).astype(np.uint8)
    for v in range(n_videos):
        seq = root / "SportsMOT" / "val" / f"v_{v:02d}_c001"
        (seq / "img1").mkdir(parents=True)
        (seq / "gt").mkdir()
        (seq / "seqinfo.ini").write_text(
            f"[Sequence]\nname={seq.name}\nimDir=img1\nframeRate=25\n"
            f"seqLength={n_frames}\nimWidth={SIZE}\nimHeight={SIZE}\n"
            "imExt=.png\n")
        gt = []
        for f in range(1, n_frames + 1):
            img = court.copy()
            for t in range(8):
                x = 4 + 14 * t + (2 - v) * f
                y = 8 + 40 * (t % 3) + (t % 2) * f
                img[y:y + 28, x:x + 12] = (210 - 18 * t, 50 + 22 * t, 140)
                img[y:y + 6, x + 3:x + 9] = (230, 190, 160)
                gt.append(f"{f},{t + 1},{x},{y},12,28,1,1,1.0")
            cv2.imwrite(str(seq / "img1" / f"{f:06d}.png"), img[..., ::-1])
        (seq / "gt" / "gt.txt").write_text("\n".join(gt) + "\n")
    return root


@contextlib.contextmanager
def _jax_checkpoints(trees):
    """JAX's ``load_checkpoint`` returning ``trees[path]`` for the paths
    given (the wrappers import it when they build)."""
    from tracklab_tpu.models import convert as JC

    load = JC.load_checkpoint
    JC.load_checkpoint = lambda path, *a, **k: (
        trees[str(path)] if str(path) in trees else load(path, *a, **k))
    try:
        yield
    finally:
        JC.load_checkpoint = load


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The seeded YOLOXPose-nano and 8-channel OSNet x0_25 draws: the
    flax trees and the port's state dicts."""
    d = tmp_path_factory.mktemp("pose_weights")
    pose = _lecun(JYOLOXPose(num_classes=1, num_keypoints=17,
                             variant="nano"), (1, SIZE, SIZE, 3), seed=0)
    torch.save(yoloxpose_from_flax(pose), d / "yoloxpose.pt")
    reid = _lecun(JOSNet(variant="x0_25", feat_dim=32, n_parts=6),
                  (1,) + CROP + (8,), seed=1)
    torch.save(osnet_from_flax(reid, n_parts=6, device="cpu").state_dict(),
               d / "osnet_kp.pt")
    return dict(dir=d, pose=pose, reid=reid)


@pytest.fixture(scope="module")
def config3(weights, tmp_path_factory):
    """``+experiment=sportsmot_pose`` on the tree through both command
    lines (JAX's modules kept for the piecewise tests below)."""
    data = _sports_tree(tmp_path_factory.mktemp("sportsmot"))
    d = weights["dir"]
    args = ARGS + [f"data_dir={data}"]
    cfg = jcompose(JM.CONFIG_DIR, "config", args + [
        f"modules.pose_estimator.checkpoint_path={d / 'pose_draw'}"])
    JM.init_environment(cfg)
    jparts = JM.build(cfg)
    jparts["modules"][1].variables = weights["reid"]
    with _jax_checkpoints({str(d / "pose_draw"): weights["pose"]}):
        jparts["engine"].track_dataset()
    cfg = tcompose(TM.CONFIG_DIR, "config", args + [
        "device=cpu",
        f"modules.pose_estimator.checkpoint_path={d / 'yoloxpose.pt'}",
        f"modules.reid.checkpoint_path={d / 'osnet_kp.pt'}"])
    tparts = TM.build(cfg, TM.init_environment(cfg))
    tparts["engine"].track_dataset()
    return dict(data=data, jax=jparts, torch=tparts,
                want=jparts["tracker_state"].detections_pred,
                got=tparts["tracker_state"].detections_pred)


def _same_pose_rows(got, want, what):
    """Row ids and frames equal, boxes within rtol 1e-4 / atol 1e-3,
    keypoints within 1e-3 px and 1e-3 of confidence, scores within 1e-6."""
    assert len(want) > 0, f"{what}: no detections"
    pd.testing.assert_index_equal(got.index, want.index)
    for col in ("image_id", "video_id", "category_id"):
        np.testing.assert_array_equal(got[col].to_numpy(float),
                                      want[col].to_numpy(float),
                                      err_msg=f"{what}: {col}")
    np.testing.assert_allclose(np.stack(got["bbox_ltwh"].to_numpy()),
                               np.stack(want["bbox_ltwh"].to_numpy()),
                               rtol=1e-4, atol=1e-3, err_msg=what)
    np.testing.assert_allclose(np.stack(got["keypoints_xyc"].to_numpy()),
                               np.stack(want["keypoints_xyc"].to_numpy()),
                               rtol=0, atol=1e-3, err_msg=what)
    np.testing.assert_allclose(got["bbox_conf"].to_numpy(float),
                               want["bbox_conf"].to_numpy(float), rtol=0,
                               atol=1e-6, err_msg=what)


def _same_tracks(got, want, what):
    wv, gv = want["track_id"].notna(), got["track_id"].notna()
    assert wv.sum() > 0, f"{what}: the tracker emitted nothing"
    np.testing.assert_array_equal(gv.to_numpy(), wv.to_numpy())
    np.testing.assert_array_equal(got.loc[gv, "track_id"].to_numpy(float),
                                  want.loc[wv, "track_id"].to_numpy(float),
                                  err_msg=what)


def test_sportsmot_pose_cli_matches_jax(config3):
    """Config 3 as typed (sportsmot.yaml, bottomup.yaml, osnet.yaml with
    use_keypoints, bpbreid_strong_sort.yaml with OKS motion), widths cut:
    the port's rows, keypoints, part embeddings and tracks against JAX's."""
    got, want = config3["got"], config3["want"]
    assert len(want) >= 2 * N_FRAMES * 4, "too few detections to mean much"
    _same_pose_rows(got, want, "config 3")
    emb_g = np.stack(got["embeddings"].to_numpy())
    emb_w = np.stack(want["embeddings"].to_numpy())
    assert emb_g.shape[1:] == (7, 32)         # n_parts + 1 rows of feat_dim
    np.testing.assert_allclose(emb_g, emb_w, rtol=0,
                               atol=1e-4 * np.abs(emb_w).max())
    # stripe visibility is a ratio of activation masses: 1e-4 as above
    np.testing.assert_allclose(
        np.stack(got["visibility_scores"].to_numpy()),
        np.stack(want["visibility_scores"].to_numpy()), rtol=0, atol=1e-4)
    _same_tracks(got, want, "config 3")
    for col in ("hits", "age", "time_since_update", "state"):
        tv = want["track_id"].notna()
        np.testing.assert_array_equal(got.loc[tv, col].to_numpy(float),
                                      want.loc[tv, col].to_numpy(float),
                                      err_msg=col)


def test_gaussian_keypoint_masks_match_jax():
    rng = np.random.default_rng(4)
    kp = np.concatenate([rng.uniform(-5, 60, (17, 2)),
                         rng.uniform(-0.2, 1, (17, 1))], axis=1)
    box = np.array([3.5, -2.0, 40.0, 70.0])
    got = TRD.gaussian_keypoint_masks(kp, CROP, box)
    np.testing.assert_array_equal(got, JRD.gaussian_keypoint_masks(
        kp, CROP, box))
    assert (got[kp[:, 2] <= 0] == 0).all() and got.max() > 0.5


def test_osnet_keypoint_reid_matches_jax(config3):
    """``OSNetReId(use_keypoints=True)`` on the run's own detections: the
    8-channel crops (RGB + 5 group prompts) and ``kp_vis`` as JAX's, then
    the embeddings and the keypoint visibility through JAX's module."""
    pred = config3["got"]
    rows = pred[pred["image_id"] == pred["image_id"].iloc[0]]
    img = np.random.default_rng(6).integers(0, 255, (SIZE, SIZE, 3),
                                            dtype=np.uint8)
    jreid, treid = config3["jax"]["modules"][1], config3["torch"]["modules"][1]
    assert treid.input_columns == ["bbox_ltwh", "keypoints_xyc"]
    samples = []
    for _, det in rows.iterrows():
        t = treid.preprocess(img, det, None)
        j = jreid.preprocess(img, det, None)
        np.testing.assert_array_equal(t["crop"], j["crop"])
        np.testing.assert_array_equal(t["kp_vis"], j["kp_vis"])
        samples.append(t)
    assert samples[0]["crop"].shape == CROP + (8,)
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    got = treid.process(batch, rows, None)
    want = jreid.process(batch, rows, None)
    for col in ("embeddings", "visibility_scores"):
        w = np.stack(want[col].to_numpy())
        np.testing.assert_allclose(np.stack(got[col].to_numpy()), w,
                                   rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=col)
    vis = np.stack(got["visibility_scores"].to_numpy())
    np.testing.assert_array_equal(vis[:, 1:6], batch["kp_vis"])
    assert (vis[:, 0] == 1).all()


def test_bottomup_process_matches_jax(config3, weights):
    """``BottomUpPoseEstimator.process`` on a batch of two letterboxed
    frames (one a 96 x 160 frame: padding and a scale) through JAX's
    module of the run."""
    import cv2
    jpose = config3["jax"]["modules"][0]
    tpose = BottomUpPoseEstimator(
        variant="nano", input_size=(SIZE, SIZE), min_confidence=0.2965,
        max_dets=16, batch_size=4, device="cpu",
        checkpoint_path=str(weights["dir"] / "yoloxpose.pt"))
    seq = sorted((config3["data"] / "SportsMOT" / "val").iterdir())[0]
    frames = [cv2.imread(str(seq / "img1" / f"{f:06d}.png"))[..., ::-1]
              for f in (1, 2)]
    frames[1] = np.ascontiguousarray(frames[1][16:112, :].repeat(
        2, axis=1)[:, 48:208])
    samples = [tpose.preprocess(f, None, None) for f in frames]
    for s, f, tol in zip(samples, frames, (0, 1)):
        # the letterbox's bilinear resize rounds as cv2's to a grey level
        # (tests/test_torch_cli.py::test_letterbox_matches_cv2)
        want = jpose.preprocess(f, None, None)
        diff = np.abs(s["image"].astype(int) - want["image"].astype(int))
        assert diff.max() <= tol
        for k in ("scale", "pad", "shape"):
            np.testing.assert_array_equal(s[k], want[k], err_msg=k)
    batch = {k: np.stack([s[k] for s in samples] * 2) for k in samples[0]}
    metas = pd.DataFrame({"video_id": [0, 0, 1, 1]}, index=[10, 11, 12, 13])
    jpose.id = 0                   # row ids count from 0 in both modules
    got = tpose.process(batch, None, metas)
    want = pd.DataFrame(jpose.process(batch, None, metas))
    _same_pose_rows(got, want, "BottomUpPoseEstimator.process")


def _part_stream(n_frames=30, n_obj=6, seed=3):
    """A hand-made stream of detection rows with (7, 32) part embeddings,
    visibilities and 17 keypoints per row: objects drift and keep their
    appearance; two vanish for a few frames; some keypoints invisible."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(10, 90, (n_obj, 2))
    vel = rng.uniform(-1.5, 1.5, (n_obj, 2))
    look = rng.normal(size=(n_obj, 7, 32)).astype(np.float32)
    shape = rng.uniform(0, 1, (n_obj, 17, 2)) * [12, 28]
    rows, images = [], []
    for f in range(n_frames):
        images.append(dict(frame=f, video_id=0))
        for o in range(n_obj):
            if o < 2 and 10 <= f < 14 + 2 * o:
                continue
            lt = start[o] + vel[o] * f + rng.normal(0, 0.4, 2)
            kp = np.concatenate([lt + shape[o] + rng.normal(0, 0.5, (17, 2)),
                                 rng.uniform(-0.1, 1, (17, 1))], 1)
            rows.append(dict(
                image_id=f, video_id=0, category_id=1,
                bbox_ltwh=np.array([*lt, 12, 28], np.float32),
                bbox_conf=float(rng.uniform(0.5, 0.9)),
                embeddings=look[o] + rng.normal(0, 0.1, (7, 32)).astype(
                    np.float32),
                visibility_scores=rng.uniform(0.3, 1, 7).astype(np.float32),
                keypoints_xyc=kp.astype(np.float32)))
    return pd.DataFrame(rows), pd.DataFrame(images)


def test_bpbreid_process_oks_matches_jax(config3):
    """``BPBReIDStrongSORT.process`` with OKS motion (the run's
    bpbreid_strong_sort.yaml values) on a 30-frame stream against JAX's
    module of the run: track ids, boxes and the lifecycle columns; then
    ``process_video_batch`` over two videos equal to ``process`` each and
    ``process_online`` frame by frame equal to ``process``."""
    jtrk = config3["jax"]["modules"][2]
    ttrk = config3["torch"]["modules"][2]
    assert isinstance(ttrk, BPBReIDStrongSORT)
    assert ttrk.params == {k: v for k, v in jtrk.params.items()}
    dets, images = _part_stream()
    want = jtrk.process(dets, images)
    got = ttrk.process(dets, images)
    assert len(want) > 100 and want["track_id"].nunique() >= 6
    pd.testing.assert_index_equal(got.index, want.index)
    np.testing.assert_array_equal(got["track_id"].to_numpy(),
                                  want["track_id"].to_numpy())
    for col in ("hits", "age", "time_since_update", "state"):
        np.testing.assert_array_equal(got[col].to_numpy(float),
                                      want[col].to_numpy(float),
                                      err_msg=col)
    for col in ("track_bbox_ltwh", "track_bbox_pred_kf_ltwh"):
        np.testing.assert_allclose(np.stack(got[col].to_numpy()),
                                   np.stack(want[col].to_numpy()),
                                   rtol=1e-5, atol=1e-3, err_msg=col)
    other, oimages = _part_stream(n_frames=20, seed=9)
    other.index = other.index + 10_000
    both = ttrk.process_video_batch([(dets, images), (other, oimages)])
    pd.testing.assert_frame_equal(both[0], got)
    pd.testing.assert_frame_equal(both[1], ttrk.process(other, oimages))
    ttrk.reset()
    online = pd.concat([ttrk.process_online(rows, images.iloc[f])
                        for f, rows in dets.groupby("image_id")])
    online = online[~online.index.duplicated(keep="last")].loc[got.index]
    np.testing.assert_array_equal(online["track_id"].to_numpy(),
                                  got["track_id"].to_numpy())
    np.testing.assert_array_equal(online["hits"].to_numpy(),
                                  got["hits"].to_numpy())


def test_bpbreid_emit_costs_columns():
    """``emit_costs`` (the reference's debug instrumentation) leaves the
    tracks as they are and adds, per row, the R / S / K costs to every
    live track with their thresholds and the stage and cost it matched
    at, within that stage's threshold."""
    dets, images = _part_stream(n_frames=12)
    args = dict(motion_criterium="oks", n_init=1, max_dets=16, max_tracks=32,
                embed_dim=32, device="cpu")
    plain = BPBReIDStrongSORT(**args).process(dets, images)
    got = BPBReIDStrongSORT(emit_costs=True, **args).process(dets, images)
    pd.testing.assert_frame_equal(got[plain.columns], plain)
    matched = got["matched_with"].dropna()
    assert len(matched) > 20
    for row, (stage, cost) in matched.items():
        c = got.at[row, "costs"]
        assert set(c) == {"R", "Rt", "S", "St", "K", "Kt"}
        assert c["St"] == 0.7 and c["Rt"] == 0.5
        assert stage in ("R", "S") and cost <= c[stage + "t"]


# ------------------------------------------------ the port's fused paths
def _torch_cli(args):
    cfg = tcompose(TM.CONFIG_DIR, "config", args + ["device=cpu"])
    parts = TM.build(cfg, TM.init_environment(cfg))
    parts["engine"].track_dataset()
    return parts["tracker_state"].detections_pred


BOTTOMUP = [
    "pipeline=[pose_estimator, track]", "+modules/pose_estimator=bottomup",
] + POSE + [
    # the synthetic frames' seeded scores are 0.28-0.31
    "modules.pose_estimator.min_confidence=0.28", "modules/track=oc_sort",
    "modules.track.min_confidence=0", "modules.track.det_thresh=0.29",
    "modules.track.max_dets=16", "modules.track.max_tracks=32",
    "dataset.n_videos=1", "dataset.n_frames=10", "dataset.n_objects=3",
    "dataset.img_w=128", "dataset.img_h=128", "use_rich=false"]


def test_fused_bottomup_equals_staged():
    """Bottom-up pose -> OC-SORT with ``engine.fused`` true
    (``run_fused_bottomup_video``: boxes from keypoints on the device) and
    false: tests/test_fused_engine.py's bounds (boxes rtol 1e-4 / atol
    1e-3, keypoints 1e-3, ids equal)."""
    staged = _torch_cli(BOTTOMUP + ["engine.fused=false"])
    fused = _torch_cli(BOTTOMUP + ["engine.fused=true"])
    assert len(staged) >= 10 * 4
    _same_pose_rows(fused, staged, "bottom-up fused vs staged")
    _same_tracks(fused, staged, "bottom-up fused vs staged")


TOPDOWN = [
    "pipeline=[bbox_detector, pose_estimator, track]",
    "+modules/bbox_detector=yolox", "modules.bbox_detector.variant=nano",
    "modules.bbox_detector.input_size=[128,128]",
    "modules.bbox_detector.min_confidence=0.25",
    "modules.bbox_detector.max_dets=16", "modules.bbox_detector.batch_size=4",
    "+modules/pose_estimator=topdown_batched",
    "modules.pose_estimator.variant=nano",
    "modules.pose_estimator.crop_size=[64,48]",
    "modules.pose_estimator.work_size=[128,128]",
    "modules.pose_estimator.max_dets=16", "modules/track=oc_sort",
    # the seeded YOLOX-nano's scores are 0.25-0.26
    "modules.track.min_confidence=0", "modules.track.det_thresh=0.2555",
    "modules.track.max_dets=16",
    "modules.track.max_tracks=32", "dataset.n_videos=1",
    "dataset.n_frames=10", "dataset.n_objects=3", "dataset.img_w=128",
    "dataset.img_h=128", "use_rich=false"]


def test_fused_pose_equals_staged():
    """YOLOX-nano -> ``TopDownPoseBatched`` (TopDownPose-nano on 64 x 48
    device crops) -> OC-SORT fused (``run_fused_pose_video``) and staged:
    the same rows, keypoints bit for bit, track ids equal."""
    staged = _torch_cli(TOPDOWN + ["engine.fused=false"])
    fused = _torch_cli(TOPDOWN + ["engine.fused=true"])
    assert len(staged) >= 10 * 2
    pd.testing.assert_index_equal(fused.index, staged.index)
    np.testing.assert_array_equal(np.stack(fused["bbox_ltwh"].to_numpy()),
                                  np.stack(staged["bbox_ltwh"].to_numpy()))
    np.testing.assert_array_equal(
        np.stack(fused["keypoints_xyc"].to_numpy()),
        np.stack(staged["keypoints_xyc"].to_numpy()))
    np.testing.assert_array_equal(fused["keypoints_conf"].to_numpy(),
                                  staged["keypoints_conf"].to_numpy())
    _same_tracks(fused, staged, "top-down fused vs staged")


def test_fused_pose_buckets_equal_full_width():
    """``fused_detect_pose_track`` with ``pose_buckets`` (the live slot
    prefix posed at the smallest bucket that holds it) gives the full-width
    run's keypoints and tracks."""
    from functools import partial

    from tracklab_torch.engine.fused import (fused_detect_pose_track,
                                             make_topdown_pose_fn,
                                             make_yolox_detect_fn)
    from tracklab_torch.models.pose import TopDownPose
    from tracklab_torch.models.yolox import YOLOX
    from tracklab_torch.trackers.ocsort import (OCSortConfig, ocsort_init,
                                                ocsort_step)

    det = make_yolox_detect_fn(
        YOLOX(num_classes=1, variant="nano", device="cpu").randomize_(0),
        conf_threshold=0.255, max_dets=16)
    pose = make_topdown_pose_fn(
        TopDownPose(variant="nano", device="cpu").randomize_(0), (64, 48))
    cfg = OCSortConfig(det_thresh=0.2555, max_tracks=32, max_dets=16)
    frames = torch.from_numpy(np.random.default_rng(8).integers(
        0, 255, (4, 128, 128, 3), dtype=np.uint8))
    runs = [fused_detect_pose_track(det, pose, partial(ocsort_step, cfg),
                                    ocsort_init(cfg, device="cpu"), frames, 2,
                                    pose_buckets=b)
            for b in (None, (4, 8, 16))]
    (_, d0, kp0, o0), (_, d1, kp1, o1) = runs
    assert int(d0.valid.sum()) > 4
    torch.testing.assert_close(kp1, kp0, rtol=0, atol=0)
    for a, b in zip(o0, o1):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_topdown_estimator_matches_jax(tmp_path):
    """``TopDownPoseEstimator`` (host crops, backbone csp) on a frame's
    rows against JAX's with the same TopDownPose-nano weights
    (``topdownpose_from_flax`` for the port): crops, keypoints within 1e-3
    px and conf."""
    from tracklab_tpu.models.pose import TopDownPose as JTopDownPose
    from tracklab_tpu.wrappers.pose_estimator import \
        TopDownPoseEstimator as JTopDown
    from tracklab_torch.models.convert import topdownpose_from_flax
    from tracklab_torch.wrappers.pose_estimator import TopDownPoseEstimator

    v = _lecun(JTopDownPose(num_keypoints=17, variant="nano"), (1, 64, 48, 3),
               seed=2)
    torch.save(topdownpose_from_flax(v), tmp_path / "td.pt")
    kw = dict(variant="nano", crop_size=(64, 48), batch_size=4)
    jmod = JTopDown(checkpoint_path=str(tmp_path / "td_draw"), **kw)
    tmod = TopDownPoseEstimator(checkpoint_path=str(tmp_path / "td.pt"),
                                device="cpu", **kw)
    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, (SIZE, SIZE, 3), dtype=np.uint8)
    rows = pd.DataFrame({"bbox_ltwh": [np.array(b, np.float32) for b in (
        [10, 12, 30, 60], [60.5, 40.25, 24, 50], [100, 90, 40, 50])]},
        index=[4, 8, 15])
    samples = [tmod.preprocess(img, r, None) for _, r in rows.iterrows()]
    for s, (_, r) in zip(samples, rows.iterrows()):
        j = jmod.preprocess(img, r, None)
        for k in ("crop", "origin", "scale"):
            np.testing.assert_array_equal(s[k], j[k], err_msg=k)
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    with _jax_checkpoints({str(tmp_path / "td_draw"): v}):
        want = jmod.process(batch, rows, None)
    got = tmod.process(batch, rows, None)
    pd.testing.assert_index_equal(got.index, want.index)
    np.testing.assert_allclose(np.stack(got["keypoints_xyc"].to_numpy()),
                               np.stack(want["keypoints_xyc"].to_numpy()),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["keypoints_conf"].to_numpy(float),
                               want["keypoints_conf"].to_numpy(float),
                               rtol=0, atol=1e-6)
