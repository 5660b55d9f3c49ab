"""The port's ReID command line against the JAX package's, on the CPU:
config composition (the ReID, camera-motion and MOT-dataset groups and
``+experiment=dancetrack_strongsort``), YOLOX-nano 128 -> OSNet x0_25 (64-d)
-> StrongSORT fused and staged (tests/test_fused_engine.py's REID_ARGS),
Deep-OC-SORT and BoT-SORT staged (and the port's fused runs equal to its
staged ones), the detection-level ``OSNetReId`` with ``CameraMotion``
(sparse optical flow) before BoT-SORT, and the wrappers' embedding and warp
tables.

The JAX YOLOX weights are its wrapper's PRNGKey(0) init (REID_ARGS's score
thresholds are set for them); the OSNet weights are seeded numpy draws on
the flax tree's shapes (a flax init of OSNet compiles for ~25 s). Both go
to the port through ``yolox_from_flax``/``osnet_from_flax`` and
``checkpoint_path``. JAX's staged ReID run is saved once; its tracker-only
runs start from that state file, which is the staged pipeline's input to
its tracker by construction.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from tracklab_tpu import main as JM
from tracklab_tpu.config import compose as jcompose
from tracklab_tpu.models.osnet import OSNet as JOSNet
from tracklab_tpu.wrappers.track import scan_tracker as JST
from tracklab_torch import main as TM
from tracklab_torch.config import compose as tcompose
from tracklab_torch.models.convert import osnet_from_flax, yolox_from_flax
from tracklab_torch.wrappers.reid import OSNetReId
from tracklab_torch.wrappers.track import scan_tracker as TST
from test_torch_yolox import jax_yolox_prng0

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

PKG = "tracklab_PKG"
OSNET = dict(variant="x0_25", feat_dim=64, n_parts=2)
CROP = (64, 32)
# tests/test_fused_engine.py's REID_ARGS
REID = [
    "pipeline=[detect, reid, track]",
    f"+modules.detect._target_={PKG}.wrappers.bbox_detector.YOLOXDetector",
    "+modules.detect.variant=nano",
    "+modules.detect.num_classes=1",
    "+modules.detect.input_size=[128,128]",
    "+modules.detect.min_confidence=0.25",
    "+modules.detect.nms_iou=0.65",
    "+modules.detect.max_dets=16",
    "+modules.detect.batch_size=4",
    f"+modules.reid._target_={PKG}.wrappers.reid.OSNetReIdBatched",
    "+modules.reid.variant=x0_25",
    "+modules.reid.feat_dim=64",
    "+modules.reid.n_parts=2",
    "+modules.reid.use_parts=false",
    "+modules.reid.crop_size=[64,32]",
    "+modules.reid.work_size=[128,128]",
    "+modules.reid.max_dets=16",
    "+modules.reid.batch_size=4",
    "modules/track=strong_sort",
    "modules.track.max_dets=16", "modules.track.max_tracks=32",
    "modules.track.embed_dim=64",
    "modules.track.min_confidence=0.28",
    "modules.track.n_init=1",
    "modules.track.max_dist=0.6", "modules.track.max_iou_dist=0.9",
    "dataset.n_videos=1", "dataset.n_frames=10",
    "dataset.n_objects=3", "dataset.img_w=128", "dataset.img_h=128",
    "use_rich=false",
]
# the same video and capacities for the other embedding trackers; the
# random-weight scores (0.27-0.32) sit below their yamls' thresholds
TRACKERS = {
    "deep_oc_sort": ["modules.track.max_dets=16",
                     "modules.track.max_tracks=32",
                     "modules.track.embed_dim=64",
                     "modules.track.min_confidence=0.28"],
    "bot_sort": ["modules.track.max_dets=16", "modules.track.max_tracks=32",
                 "modules.track.embed_dim=64",
                 "modules.track.min_confidence=0.28",
                 "modules.track.track_high_thresh=0.29",
                 "modules.track.new_track_thresh=0.29"],
}
# the detection-level OSNetReId (osnet.yaml's part layout, 2 stripes) and
# CameraMotion (sparse optical flow at full resolution) before BoT-SORT
CMC = ["pipeline=[detect, reid, cmc, track]",
       f"+modules.reid._target_={PKG}.wrappers.reid.OSNetReId",
       "+modules.reid.variant=x0_25", "+modules.reid.feat_dim=64",
       "+modules.reid.n_parts=2", "+modules.reid.crop_size=[64,32]",
       "+modules.reid.batch_size=8",
       "+modules/cmc=sparse_opt_flow", "modules.cmc.downscale=1",
       "modules/track=bot_sort"] + TRACKERS["bot_sort"]


def _args(args, pkg):
    return [a.replace(PKG, pkg) for a in args]


def _osnet_variables():
    """Seeded OSNet x0_25 variables in the flax tree's shapes (no init
    program is compiled): He-normal kernels, norm scales and variances in
    [0.5, 1.5], biases and means N(0, 0.05)."""
    shapes = jax.eval_shape(lambda: JOSNet(**OSNET).init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + CROP + (3,)), train=False))
    rng = np.random.default_rng(7)

    def draw(path, a):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            return rng.normal(0, np.sqrt(2.0 / fan_in), a.shape).astype(
                np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return rng.normal(0, 0.05, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_run(args, weights):
    """The JAX CLI in this process with the test's weights set on its
    detector and ReID modules; returns (detections_pred, image_pred)."""
    cfg = jcompose(JM.CONFIG_DIR, "config", _args(args, "tracklab_tpu"))
    JM.init_environment(cfg)
    parts = JM.build(cfg)
    for m in parts["modules"]:
        if hasattr(m, "_make_model"):
            m._variables = weights["yolox"]
        elif hasattr(m, "variables"):
            m.variables = weights["osnet"]
    parts["engine"].track_dataset()
    st = parts["tracker_state"]
    return st.detections_pred, st.image_pred


def _torch_run(args, weights):
    modules = [a.split("=")[0].split(".")[1] for a in args
               if a.startswith("+modules.") and "._target_=" in a]
    ckpts = [f"+modules.{m}.checkpoint_path={weights[m]}" for m in modules
             if m in ("detect", "reid")]
    parts, _ = TM.main(_args(args, "tracklab_torch") + ckpts
                       + ["device=cpu"])
    st = parts["tracker_state"]
    return st.detections_pred, st.image_pred


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX's PRNGKey(0) YOLOX-nano init (its wrapper's own weights,
    computed once per session) and the seeded OSNet tree, each also as a
    port checkpoint."""
    yv = jax_yolox_prng0(tmp_path_factory, "nano")
    ov = _osnet_variables()
    tmp = tmp_path_factory.mktemp("reid")
    torch.save(yolox_from_flax(jax.tree_util.tree_map(np.asarray, yv)),
               tmp / "yolox.pt")
    torch.save(osnet_from_flax(jax.tree_util.tree_map(np.asarray, ov),
                               n_parts=OSNET["n_parts"],
                               device="cpu").state_dict(), tmp / "osnet.pt")
    return {"yolox": yv, "osnet": ov, "detect": tmp / "yolox.pt",
            "reid": tmp / "osnet.pt", "tmp": tmp}


@pytest.fixture(scope="module")
def strongsort_runs(weights):
    """JAX's staged (saved as a state file) and fused runs of REID and the
    port's fused and staged runs."""
    state = weights["tmp"] / "jax_staged.pklz"
    jax_runs = {
        "staged": _jax_run(REID + ["engine.fused=false",
                                   f"state.save_file={state}"], weights)[0],
        "fused": _jax_run(REID + ["engine.fused=true"], weights)[0]}
    runs = {name: _torch_run(REID + [f"engine.fused={fused}"], weights)[0]
            for name, fused in (("fused", "true"), ("staged", "false"))}
    return jax_runs, runs, state


def _assert_same_rows(got, want, emb_rtol=1e-3):
    """tests/test_fused_engine.py's assertions: the same rows, ids and
    categories, boxes within rtol 1e-4 / atol 1e-3, embeddings within
    ``emb_rtol`` of their scale, the same visibility and track ids."""
    assert len(want) > 0, "no detections"
    pd.testing.assert_index_equal(got.index, want.index)
    for col in ("image_id", "video_id", "category_id"):
        np.testing.assert_array_equal(got[col].to_numpy(float),
                                      want[col].to_numpy(float),
                                      err_msg=col)
    np.testing.assert_allclose(np.stack(got["bbox_ltwh"].to_numpy()),
                               np.stack(want["bbox_ltwh"].to_numpy()),
                               rtol=1e-4, atol=1e-3)
    emb = np.stack(want["embeddings"].to_numpy())
    np.testing.assert_allclose(np.stack(got["embeddings"].to_numpy()), emb,
                               rtol=0, atol=emb_rtol * np.abs(emb).max())
    np.testing.assert_allclose(
        np.stack(got["visibility_scores"].to_numpy()),
        np.stack(want["visibility_scores"].to_numpy()), rtol=0, atol=1e-5)
    wv, gv = want["track_id"].notna(), got["track_id"].notna()
    assert wv.sum() > 0, "the tracker emitted nothing"
    np.testing.assert_array_equal(gv.to_numpy(), wv.to_numpy())
    np.testing.assert_array_equal(got.loc[gv, "track_id"].to_numpy(float),
                                  want.loc[wv, "track_id"].to_numpy(float))
    np.testing.assert_allclose(
        np.stack(got.loc[gv, "track_bbox_ltwh"].to_numpy()),
        np.stack(want.loc[wv, "track_bbox_ltwh"].to_numpy()),
        rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("jax_mode", ["staged", "fused"])
@pytest.mark.parametrize("mode", ["fused", "staged"])
def test_strongsort_cli_matches_jax(strongsort_runs, mode, jax_mode):
    """YOLOX-nano -> OSNet -> StrongSORT, each port run against each JAX
    run (StrongSORT reads no class, so JAX's fused and staged runs agree);
    embeddings within rel 1e-3 of their scale, as JAX's own test holds its
    fused run to its staged one."""
    jax_runs, runs, _ = strongsort_runs
    _assert_same_rows(runs[mode], jax_runs[jax_mode])


def test_strongsort_fused_equals_staged(strongsort_runs):
    """The port's fused run crops where its staged run crops (the boxes the
    ReID module reads back from bbox_ltwh), so the two are equal."""
    _, runs, _ = strongsort_runs
    _assert_same_rows(runs["fused"], runs["staged"], emb_rtol=1e-6)


@pytest.fixture(scope="module", params=list(TRACKERS))
def tracker_runs(request, weights, strongsort_runs):
    """JAX's staged run of one embedding tracker (started from the staged
    ReID run's state file) and the port's staged and fused runs."""
    _, _, state = strongsort_runs
    tracker = request.param
    args = REID + [f"modules/track={tracker}"] + TRACKERS[tracker]
    want, _ = _jax_run(["pipeline=[track]", f"modules/track={tracker}",
                        f"state.load_file={state}", "dataset.n_videos=1",
                        "dataset.n_frames=10", "dataset.n_objects=3",
                        "dataset.img_w=128", "dataset.img_h=128",
                        "use_rich=false"] + TRACKERS[tracker], weights)
    runs = {name: _torch_run(args + [f"engine.fused={fused}"], weights)[0]
            for name, fused in (("fused", "true"), ("staged", "false"))}
    return tracker, want, runs


def test_embedding_tracker_cli_matches_jax(tracker_runs):
    """Deep-OC-SORT and BoT-SORT staged against JAX's staged run."""
    _, want, runs = tracker_runs
    _assert_same_rows(runs["staged"], want)


def test_embedding_tracker_fused_equals_staged(tracker_runs):
    """The port's fused run hands the tracker category_id and the ltwh
    round trip of the boxes, as its staged run reads them, so the two are
    equal (Deep-OC-SORT scales its angle cost by the class column)."""
    _, _, runs = tracker_runs
    _assert_same_rows(runs["fused"], runs["staged"], emb_rtol=1e-6)


@pytest.fixture(scope="module")
def cmc_runs(weights, strongsort_runs):
    """The detection-level OSNetReId and CameraMotion before BoT-SORT: JAX
    from the staged run's detections, the port's whole pipeline."""
    _, _, state = strongsort_runs
    want = _jax_run(CMC[1:] + ["pipeline=[reid, cmc, track]",
                               f"state.load_file={state}"] + [
        a for a in REID if a.startswith("dataset.")] + ["use_rich=false"],
        weights)
    got = _torch_run(
        [a for a in REID if not a.startswith(("+modules.reid", "pipeline",
                                              "modules.track",
                                              "modules/track"))] + CMC,
        weights)
    return got, want


def test_osnet_reid_cli_matches_jax(cmc_runs):
    """OSNetReId: host crops (crop_bbox, cv2 bilinear resize) -> OSNet in
    the part layout (n_parts + 1, 64) against JAX's, and the tracks."""
    (got, _), (want, _) = cmc_runs
    assert np.stack(want["embeddings"].to_numpy()).shape[1:] == (3, 64)
    _assert_same_rows(got, want)


def test_camera_motion_cli_matches_jax(cmc_runs):
    """CameraMotion's gmc_warp column, frame by frame (identity on the
    first frame), equal to JAX's; some warp is not the identity."""
    (_, got), (_, want) = cmc_runs
    pd.testing.assert_index_equal(got.index, want.index)
    g = np.stack(got["gmc_warp"].to_numpy())
    w = np.stack(want["gmc_warp"].to_numpy())
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(g[0], np.eye(2, 3))
    assert np.abs(w - np.eye(2, 3)).max() > 1e-3, "every warp the identity"


def _embedding_table():
    """Rows of two frames: flat and part-layout embeddings, one wider and
    one narrower than the tracker's width, one None, one frame empty."""
    rng = np.random.default_rng(3)
    rows = pd.DataFrame({
        "image_id": [10, 10, 10, 12, 12],
        "bbox_ltwh": [np.array([i, i, 5, 5], np.float32) for i in range(5)],
        "bbox_conf": [0.9, 0.8, 0.7, 0.95, 0.6],
        "category_id": [1] * 5,
        "embeddings": [rng.normal(size=8).astype(np.float32),
                       rng.normal(size=(3, 8)).astype(np.float32),
                       None,
                       rng.normal(size=12).astype(np.float32),
                       rng.normal(size=5).astype(np.float32)],
    }, index=[7, 3, 2 ** 33, 11, 5])
    images = pd.DataFrame({"video_id": [0, 0, 0], "frame": [1, 2, 3]},
                          index=[10, 11, 12])
    return rows, images


def test_collect_embeddings_matches_jax():
    rows, images = _embedding_table()
    tdets, n, lut = TST._pad_video(rows, images, 4, 4, device="cpu")
    jdets, jn, jlut = JST._pad_video(rows, images, 4, 4)
    got = TST._collect_embeddings(rows, tdets, lut, n, 8)
    want = JST._collect_embeddings(rows, jdets, jlut, jn, 8)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).sum() > 0


def test_collect_warps_matches_jax():
    rng = np.random.default_rng(4)
    images = pd.DataFrame({
        "video_id": [0] * 4, "frame": [1, 2, 3, 4],
        "gmc_warp": [np.eye(2, 3, dtype=np.float32),
                     rng.normal(size=(2, 3)).astype(np.float32), None,
                     rng.normal(size=(3, 3))]}, index=[4, 5, 6, 7])
    for metas in (images, images.drop(columns="gmc_warp")):
        np.testing.assert_array_equal(TST._collect_warps(metas, 4, 8),
                                      JST._collect_warps(metas, 4, 8))


def test_osnet_checkpoint_forms(tmp_path):
    """``checkpoint_path`` takes the port's state dict (loaded strict) or a
    torchreid one (``module.`` prefix, a classifier, no part head, under
    ``state_dict``); both give the same global embeddings."""
    from tracklab_torch.models.osnet import OSNet
    model = OSNet(**OSNET, device="cpu").randomize_(3)
    port = {k: v.clone() for k, v in model.state_dict().items()}
    torchreid = {"module." + k: v for k, v in port.items()
                 if not k.startswith("part_fc.")}
    torchreid["module.classifier.weight"] = torch.zeros(10, 64)
    torch.save(port, tmp_path / "port.pt")
    torch.save({"state_dict": torchreid}, tmp_path / "torchreid.pt")
    crops = np.random.default_rng(5).uniform(
        0, 255, (3,) + CROP + (3,)).astype(np.float32)
    rows = pd.DataFrame(index=[4, 9, 2])
    out = {name: OSNetReId(checkpoint_path=str(tmp_path / f"{name}.pt"),
                           use_parts=False, device="cpu", **OSNET)
           .process({"crop": crops}, rows, None)
           for name in ("port", "torchreid")}
    got = np.stack(out["torchreid"]["embeddings"].to_numpy())
    want = np.stack(out["port"]["embeddings"].to_numpy())
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 64) and np.abs(want).max() > 0


def test_osnet_reid_raises_for_what_waits():
    """The zoo backbones build (test_torch_reid_zoo*.py hold them against
    JAX); training waits for ROADMAP item 6."""
    reid = OSNetReId(backbone="resnet50", device="cpu")
    reid._build()
    assert type(reid._model).__name__ == "ReidResNet"
    assert not reid.use_parts and not reid.use_keypoints
    with pytest.raises(NotImplementedError, match="ROADMAP item 6"):
        OSNetReId(device="cpu").train()


def test_osnet_reid_keypoint_path_builds():
    """``OSNetReId(use_keypoints=True)`` (BASELINE config 3's ReID) reads
    ``keypoints_xyc``, feeds OSNet 3 + 5 prompt channels and returns
    (n_parts + 1, feat_dim) parts whose stripes 1..5 carry the keypoint
    groups' visibility."""
    reid = OSNetReId(use_keypoints=True, crop_size=CROP, device="cpu",
                     **OSNET)
    assert reid.input_columns == ["bbox_ltwh", "keypoints_xyc"]
    rng = np.random.default_rng(2)
    image = rng.integers(0, 255, (96, 80, 3), dtype=np.uint8)
    kp = np.concatenate([rng.uniform(10, 60, (17, 2)),
                         rng.uniform(-0.5, 1, (17, 1))], 1).astype(np.float32)
    dets = pd.DataFrame({"bbox_ltwh": [np.array([8, 6, 50, 70], np.float32)]
                         * 2, "keypoints_xyc": [kp, None]}, index=[3, 7])
    samples = [reid.preprocess(image, d, None) for _, d in dets.iterrows()]
    assert samples[0]["crop"].shape == CROP + (8,)
    assert samples[1]["crop"][..., 3:].max() == 0     # no keypoints, no prompt
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    out = reid.process(batch, dets, None)
    parts = np.stack(out["embeddings"].to_numpy())
    vis = np.stack(out["visibility_scores"].to_numpy())
    assert parts.shape == (2, OSNET["n_parts"] + 1, OSNET["feat_dim"])
    assert reid._model.conv1.conv.weight.shape[1] == 8
    groups = [kp[g, 2].max() for g in OSNetReId.KP_GROUPS]
    g = min(len(groups), OSNET["n_parts"])
    np.testing.assert_array_equal(vis[0, 1:1 + g], np.float32(groups[:g]))
    np.testing.assert_array_equal(vis[1, 1:1 + g], 0)
    assert (vis[:, 0] == 1).all()


def _as_jax_targets(node):
    if isinstance(node, dict):
        return {k: (v.replace("tracklab_torch.", "tracklab_tpu.")
                    if k == "_target_" else _as_jax_targets(v))
                for k, v in node.items() if k != "device"}
    if isinstance(node, list):
        return [_as_jax_targets(v) for v in node]
    return node


@pytest.mark.parametrize("overrides", [
    ["+experiment=dancetrack_strongsort", "data_dir=/data/x"],
    ["+experiment=dancetrack_strongsort", "modules/track=deep_oc_sort",
     "dataset.nframes=16", "modules.reid.batch_size=64"],
    ["pipeline=[bbox_detector,reid,cmc,track]",
     "+modules/bbox_detector=yolox", "+modules/reid=osnet_batched",
     "+modules/cmc=sparse_opt_flow", "modules/track=bot_sort",
     "modules.cmc.method=lk_jax"],
    ["dataset=mot17", "+modules/reid=osnet", "modules/track=strong_sort"],
    ["dataset=mot20"], ["dataset=sportsmot"], ["dataset=bee24"],
], ids=["experiment", "experiment-overrides", "reid-cmc", "mot17-osnet",
        "mot20", "sportsmot", "bee24"])
def test_compose_matches_jax(overrides):
    got = tcompose(TM.CONFIG_DIR, "config", overrides)
    want = jcompose(JM.CONFIG_DIR, "config", overrides)
    assert got["device"] == "cuda"
    assert _as_jax_targets(got) == {k: v for k, v in want.items()
                                    if k != "device"}


def test_experiment_raises_without_a_card():
    cfg = tcompose(TM.CONFIG_DIR, "config",
                   ["+experiment=dancetrack_strongsort"])
    assert cfg.pipeline == ["bbox_detector", "reid", "track"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TM.init_environment(cfg)

