"""The port's command line against the JAX package's, on the CPU: config
composition, the synthetic generator, the GT -> OC-SORT / ByteTrack quick
start (results and tracks id for id), the metrics, the YOLOX-nano detector
CLI fused and staged (and fused equal to staged on crowded frames), the
letterbox against cv2, ``_pad_video``, and state files read across the two
packages."""
import types

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from tracklab_tpu import main as JM
from tracklab_tpu.config import compose as jcompose
from tracklab_tpu.datastruct.tracker_state import TrackerState as JState
from tracklab_tpu.eval.evaluator import TrackEvalEvaluator as JEval
from tracklab_tpu.wrappers.bbox_detector.yolox_api import \
    YOLOXDetector as JYOLOXDetector
from tracklab_tpu.wrappers.dataset.synthetic import \
    make_synthetic_set as jmake_set
from tracklab_tpu.wrappers.track.scan_tracker import _pad_video as jpad
from tracklab_torch import main as TM
from tracklab_torch.config import compose as tcompose
from tracklab_torch.datastruct.tracker_state import TrackerState as TState
from tracklab_torch.eval.evaluator import TrackEvalEvaluator as TEval
from tracklab_torch.models.convert import yolox_from_flax
from tracklab_torch.wrappers.bbox_detector.yolox_api import (YOLOXDetector,
                                                             letterbox)
from tracklab_torch.wrappers.dataset.synthetic import \
    make_synthetic_set as tmake_set
from tracklab_torch.wrappers.track.scan_tracker import _pad_video as tpad
from test_torch_yolox import jax_yolox_prng0

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

GT = ("state.load_from_groundtruth="
      "{detection: [bbox_ltwh, bbox_conf, category_id]}")
# tests/test_e2e.py's quick-start configuration
QUICK = ["dataset.n_videos=2", "dataset.n_frames=40", "dataset.n_objects=5",
         GT, "use_rich=false"]
# tests/test_fused_engine.py's detector configuration, on 128 x 128 frames
# so that the letterbox is the identity
DETECT = [
    "pipeline=[detect, track]",
    "+modules.detect.variant=nano",
    "+modules.detect.num_classes=1",
    "+modules.detect.input_size=[128,128]",
    "+modules.detect.min_confidence=0.25",
    "+modules.detect.nms_iou=0.65",
    "+modules.detect.max_dets=16",
    "+modules.detect.batch_size=4",
    "modules/track=oc_sort",
    "modules.track.min_confidence=0",
    "modules.track.det_thresh=0.29",
    "modules.track.max_dets=16", "modules.track.max_tracks=32",
    "dataset.n_videos=1", "dataset.n_frames=10",
    "dataset.n_objects=3", "dataset.img_w=128", "dataset.img_h=128",
    "use_rich=false",
]
DETECTOR = "wrappers.bbox_detector.YOLOXDetector"


def _jax_run(args):
    return JM.run(jcompose(JM.CONFIG_DIR, "config", args))


def _torch_run(args):
    return TM.main(args + ["device=cpu"])


def _as_jax_targets(node):
    """The port's config with its _target_s spelled as the JAX package's
    and without ``device``."""
    if isinstance(node, dict):
        return {k: (v.replace("tracklab_torch.", "tracklab_tpu.")
                    if k == "_target_" else _as_jax_targets(v))
                for k, v in node.items() if k != "device"}
    if isinstance(node, list):
        return [_as_jax_targets(v) for v in node]
    return node


@pytest.mark.parametrize("overrides", [
    [],
    ["modules/track=bytetrack", "num_cores=2", "eval_set=train"],
    ["pipeline=[bbox_detector,track]", "+modules/bbox_detector=yolox",
     "engine.fused=true", "modules.bbox_detector.input_size=[320,320]"],
    [GT, "dataset.n_frames=40", "+modules.track.n_frame_bucket=32"],
    DETECT + ["+modules.detect._target_=tracklab_TARGET." + DETECTOR],
], ids=["defaults", "group-interp", "plus-group-list", "gt-dict",
        "plus-leaves"])
def test_compose_matches_jax(overrides):
    def ov(pkg):
        return [o.replace("tracklab_TARGET", pkg) for o in overrides]

    got = tcompose(TM.CONFIG_DIR, "config", ov("tracklab_torch"))
    want = jcompose(JM.CONFIG_DIR, "config", ov("tracklab_tpu"))
    assert got["device"] == "cuda"
    assert _as_jax_targets(got) == {k: v for k, v in want.items()
                                    if k != "device"}


def test_device_defaults_to_cuda_and_raises_without_a_card():
    cfg = tcompose(TM.CONFIG_DIR, "config", [])
    assert cfg.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TM.init_environment(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP item 6"):
        YOLOXDetector(quant="int8", device="cpu")
    # training is ported (models/detector_train_engine.py): a set without
    # images trains nothing
    empty = types.SimpleNamespace(sets={"train": types.SimpleNamespace(
        detections_gt=pd.DataFrame(), image_metadatas=pd.DataFrame())})
    assert YOLOXDetector(variant="nano", input_size=(64, 64),
                         device="cpu").train(empty) == {}


def test_synthetic_set_matches_jax():
    kw = dict(n_videos=2, n_frames=12, n_objects=4, seed=3, det_noise=2.0,
              det_dropout=0.1, fp_rate=0.3, img_w=320, img_h=240,
              id_offset=2, with_keypoints=True)
    got, want = tmake_set(**kw), jmake_set(**kw)
    for name in ("video_metadatas", "image_metadatas"):
        pd.testing.assert_frame_equal(getattr(got, name),
                                      getattr(want, name))
    g, w = got.detections_gt, want.detections_gt
    pd.testing.assert_index_equal(g.index, w.index)
    assert list(g.columns) == list(w.columns)
    for col in g.columns:
        np.testing.assert_equal(list(g[col]), list(w[col]), err_msg=col)
    from tracklab_torch.utils.cv2 import cv2_load_image
    from tracklab_tpu.utils.cv2 import cv2_load_image as jload
    path = want.image_metadatas["file_path"].iloc[-1]
    np.testing.assert_array_equal(cv2_load_image(path), jload(path))


@pytest.fixture(scope="module")
def quick(tmp_path_factory):
    """The quick start through both CLIs, once per tracker."""
    tmp = tmp_path_factory.mktemp("quick")
    runs = {}
    for tracker in ("oc_sort", "bytetrack"):
        args = QUICK + [f"modules/track={tracker}"]
        jparts, jres = _jax_run(
            args + [f"state.save_file={tmp}/jax_{tracker}.pklz"])
        tparts, tres = _torch_run(
            args + [f"state.save_file={tmp}/torch_{tracker}.pklz"])
        runs[tracker] = (jparts, jres, tparts, tres)
    return tmp, runs


def _assert_results_equal(got, want, rtol=0.0, atol=0.0):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], float),
                                   np.asarray(want[k], float), rtol=rtol,
                                   atol=atol, err_msg=k)


def _assert_tracks_equal(got, want):
    pd.testing.assert_index_equal(got.index, want.index)
    np.testing.assert_array_equal(got["track_id"].to_numpy(float),
                                  want["track_id"].to_numpy(float))
    tv = want["track_id"].notna().to_numpy()
    # widths are differences of f32 coordinates near 1000 px (ulp 6.1e-5):
    # 2.5e-4 px is 4 ulps
    np.testing.assert_allclose(
        np.stack(got["track_bbox_ltwh"].to_numpy()[tv]),
        np.stack(want["track_bbox_ltwh"].to_numpy()[tv]), rtol=0,
        atol=2.5e-4)


@pytest.mark.parametrize("tracker", ["oc_sort", "bytetrack"])
def test_quick_start_matches_jax(quick, tracker):
    _, runs = quick
    jparts, jres, tparts, tres = runs[tracker]
    if tracker == "oc_sort":          # the README's quick start
        assert tres["COMBINED_SEQ"]["HOTA"] == 100.0
        assert tres["COMBINED_SEQ"]["IDSW"] == 0
    # the counts are equal; LocA and MOTP sum IoUs of track boxes that
    # differ from JAX's by float rounding (ByteTrack: ~1e-6 px)
    assert tres["per_seq"].keys() == jres["per_seq"].keys()
    for name in jres["per_seq"]:
        _assert_results_equal(tres["per_seq"][name], jres["per_seq"][name],
                              rtol=1e-7)
    _assert_results_equal(tres["COMBINED_SEQ"], jres["COMBINED_SEQ"],
                          rtol=1e-7)
    _assert_tracks_equal(tparts["tracker_state"].detections_pred,
                         jparts["tracker_state"].detections_pred)


def _read_state(cls, tracking_set, path):
    state = cls(tracking_set, load_file=path)
    parts = []
    for vid in tracking_set.video_metadatas.index:
        with state(vid):
            parts.append(state.load()[0])
    return pd.concat(parts)


@pytest.mark.parametrize("direction", ["jax-to-torch", "torch-to-jax"])
def test_state_files_load_across_packages(quick, direction):
    tmp, runs = quick
    jparts, _, tparts, _ = runs["oc_sort"]
    if direction == "jax-to-torch":
        written, reader = jparts, (TState, tparts)
        path = tmp / "jax_oc_sort.pklz"
    else:
        written, reader = tparts, (JState, jparts)
        path = tmp / "torch_oc_sort.pklz"
    cls, parts = reader
    loaded = _read_state(cls, parts["dataset"].sets["val"], path)
    want = written["tracker_state"].detections_pred
    _assert_tracks_equal(loaded, want)
    for col in ("image_id", "video_id", "category_id", "bbox_conf"):
        np.testing.assert_array_equal(loaded[col].to_numpy(float),
                                      want[col].to_numpy(float))


def test_metrics_match_jax_on_noisy_tables():
    """HOTA/CLEAR/Identity of noisy predictions (noise 2.0, dropout 0.1,
    fp 0.3, two ids swapped halfway) against the clean GT, through each
    package's evaluator."""
    gt = tmake_set(n_videos=2, n_frames=60, n_objects=6, seed=4)
    noisy = tmake_set(n_videos=2, n_frames=60, n_objects=6, seed=4,
                      det_noise=2.0, det_dropout=0.1, fp_rate=0.3)
    pred = noisy.detections_gt.copy()
    late = pred["frame"] > 30
    for a, b in ((1, 2), (2, 1)):
        pred.loc[late & (noisy.detections_gt["track_id"] == a),
                 "track_id"] = b
    state = types.SimpleNamespace(
        image_metadatas=gt.image_metadatas,
        video_metadatas=gt.video_metadatas,
        detections_gt=gt.detections_gt, detections_pred=pred)
    got = TEval(num_parallel=2).run(state)
    want = JEval(num_parallel=2).run(state)
    assert 0 < want["COMBINED_SEQ"]["HOTA"] < 100
    assert want["COMBINED_SEQ"]["IDSW"] > 0
    for name in want["per_seq"]:
        _assert_results_equal(got["per_seq"][name], want["per_seq"][name],
                              atol=1e-12)
    _assert_results_equal(got["COMBINED_SEQ"], want["COMBINED_SEQ"],
                          atol=1e-12)


def _jax_detector_run(args, fused, variables):
    """The JAX CLI's detector run on ``variables``."""
    cfg = jcompose(JM.CONFIG_DIR, "config", args + [
        "+modules.detect._target_=tracklab_tpu." + DETECTOR,
        f"engine.fused={fused}"])
    JM.init_environment(cfg)
    jparts = JM.build(cfg)
    jdet = jparts["modules"][0]
    jdet._variables = variables
    jparts["engine"].track_dataset()
    return jparts["tracker_state"].detections_pred, variables


def _torch_detector_run(args, fused, ckpt):
    tparts, _ = _torch_run(args + [
        "+modules.detect._target_=tracklab_torch." + DETECTOR,
        f"+modules.detect.checkpoint_path={ckpt}",
        f"engine.fused={fused}"])
    return tparts["tracker_state"].detections_pred


@pytest.fixture(scope="module")
def detector_runs(tmp_path_factory):
    """JAX's fused detector CLI run, its PRNGKey(0) YOLOX-nano weights
    carried into a state dict, and the port's fused and staged runs on
    them."""
    want, variables = _jax_detector_run(
        DETECT, "true", jax_yolox_prng0(tmp_path_factory, "nano"))
    ckpt = tmp_path_factory.mktemp("detect") / "yolox_nano.pt"
    torch.save(yolox_from_flax(jax.tree_util.tree_map(np.asarray,
                                                      variables)), ckpt)
    runs = {fused: _torch_detector_run(DETECT, str(fused).lower(), ckpt)
            for fused in (True, False)}
    return want, runs, ckpt, variables


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_detector_cli_matches_jax_fused(detector_runs, fused):
    """tests/test_fused_engine.py's assertions, port run vs JAX fused."""
    want, runs, _, _ = detector_runs
    _assert_same_rows(runs[fused], want)


# tests/test_fused_engine.py's detector configuration with 12 objects over
# 24 frames: crowded enough that OC-SORT's velocity cost decides matches
CROWDED = [a for a in DETECT if not a.startswith(("dataset.n_frames",
                                                  "dataset.n_objects"))
           ] + ["dataset.n_frames=24", "dataset.n_objects=12"]


@pytest.fixture(scope="module")
def crowded_runs(detector_runs):
    """The JAX package's staged and fused runs and the port's fused and
    staged runs of CROWDED on the same YOLOX-nano weights."""
    _, _, ckpt, variables = detector_runs
    jax_runs = {fused: _jax_detector_run(CROWDED, fused, variables)[0]
                for fused in ("false", "true")}
    runs = {fused: _torch_detector_run(CROWDED, fused, ckpt)
            for fused in ("true", "false")}
    assert len(jax_runs["false"]) > 12 * 24 // 2
    return jax_runs, runs


def test_fused_equals_staged_on_crowded_frames(crowded_runs):
    """The port's fused run feeds the tracker what its staged run reads
    back from the detector's rows (category_id, and boxes through ltwh),
    so the two stay equal where OC-SORT's velocity cost decides."""
    _, runs = crowded_runs
    _assert_same_rows(runs["true"], runs["false"])


@pytest.mark.parametrize("fused", ["true", "false"], ids=["fused", "staged"])
def test_crowded_cli_matches_jax_staged(crowded_runs, fused):
    """Port run vs the JAX package's staged run on crowded frames."""
    jax_runs, runs = crowded_runs
    _assert_same_rows(runs[fused], jax_runs["false"])


def test_jax_fused_parts_from_staged_on_crowded_frames(crowded_runs,
                                                       record_property):
    """The reference fault the port does not copy: the JAX package's fused
    run hands OC-SORT the class index (0) where its staged run hands it
    category_id (1), so the fused run drops the velocity cost
    (``angle_cost_scale="category"``) and gives other track ids on
    crowded frames. The rows and boxes still agree."""
    jax_runs, _ = crowded_runs
    fused, staged = jax_runs["true"], jax_runs["false"]
    pd.testing.assert_index_equal(fused.index, staged.index)
    np.testing.assert_allclose(np.stack(fused["bbox_ltwh"].to_numpy()),
                               np.stack(staged["bbox_ltwh"].to_numpy()),
                               rtol=1e-4, atol=1e-3)
    parted = (fused["track_id"].fillna(-1).to_numpy(float)
              != staged["track_id"].fillna(-1).to_numpy(float))
    record_property("rows_with_other_track_ids",
                    f"{int(parted.sum())} of {len(staged)}")
    assert parted.sum() > 0, "the JAX fused and staged runs agree here"


def _assert_same_rows(got, want):
    assert len(want) > 0, "no detections"
    pd.testing.assert_index_equal(got.index, want.index)
    for col in ("image_id", "video_id", "category_id"):
        np.testing.assert_array_equal(got[col].to_numpy(float),
                                      want[col].to_numpy(float),
                                      err_msg=col)
    np.testing.assert_allclose(np.stack(got["bbox_ltwh"].to_numpy()),
                               np.stack(want["bbox_ltwh"].to_numpy()),
                               rtol=1e-4, atol=1e-3)
    wv, gv = want["track_id"].notna(), got["track_id"].notna()
    assert wv.sum() > 0, "the tracker emitted nothing"
    np.testing.assert_array_equal(gv.to_numpy(), wv.to_numpy())
    np.testing.assert_array_equal(got.loc[gv, "track_id"].to_numpy(float),
                                  want.loc[wv, "track_id"].to_numpy(float))
    np.testing.assert_allclose(
        np.stack(got.loc[gv, "track_bbox_ltwh"].to_numpy()),
        np.stack(want.loc[wv, "track_bbox_ltwh"].to_numpy()),
        rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("src,dst", [((1080, 1920), (640, 640)),
                                     ((120, 160), (128, 128)),
                                     ((128, 128), (128, 128))],
                         ids=["1080p-640", "160x120-128", "equal"])
def test_letterbox_matches_cv2(src, dst):
    rng = np.random.default_rng(sum(src))
    image = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    got = letterbox(image, dst)
    want = JYOLOXDetector(input_size=dst).preprocess(image, None, None)
    for k in ("scale", "pad", "shape"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    diff = np.abs(got["image"].astype(int) - want["image"].astype(int))
    assert diff.max() <= (0 if src == dst else 1), diff.max()


def test_pad_video_matches_jax():
    s = tmake_set(n_videos=1, n_frames=70, n_objects=6, seed=5,
                  det_noise=1.0, det_dropout=0.2, fp_rate=2.0)
    dets = s.detections_gt.copy()
    dets.index = dets.index + 2 ** 33          # row ids beyond int32
    dets["category_id"] = dets["category_id"].astype(object)
    dets.loc[dets.index[3], "category_id"] = "x"   # non-numeric class
    got, n, lut = tpad(dets, s.image_metadatas, 7, 32, device="cpu")
    want, jn, jlut = jpad(dets, s.image_metadatas, 7, 32)
    assert (n, got.ltrb.shape[0]) == (jn, 96)
    np.testing.assert_array_equal(lut, jlut)
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
