"""The port's game-state slice against the JAX package's on the CPU: the
synthetic ``game_state`` set, the SoccerNet GS loader and its
``save_for_eval`` export, GS-HOTA (``gs_metrics`` against JAX and
tests/oracles/gs_hota_oracle.py, ``GameStateEvaluator``), SoccerAccuracy,
jersey OCR without easyocr, the game-state chain through
``tracklab_torch.main.run`` (OSNet -> StrongSORT -> OCR -> vote -> TVCalib
-> pitch projection -> GS-HOTA; JAX's own test of the chain uses KPR, which
waits for ROADMAP item 3), and the reference fault of config 4 as typed:
no module fills ``pitch_lines``, so calibration emits nothing and no
detection gets ``bbox_pitch``, in both packages.
"""
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from test_gs_hota_oracle import random_stream
from test_soccernet import make_gs_video
from tests.oracles.gs_hota_oracle import gs_hota_oracle
from tracklab_tpu import main as JM
from tracklab_tpu.config import compose as jcompose
from tracklab_tpu.eval import gs_evaluator as JGE
from tracklab_tpu.eval.gs_metrics import \
    make_gs_sequence_data as jmake_gs_data
from tracklab_tpu.eval.metrics import hota_metrics as jhota
from tracklab_tpu.models.osnet import OSNet as JOSNet
from tracklab_tpu.wrappers import calibration_api as JAPI
from tracklab_tpu.wrappers.dataset import soccernet as JSN
from tracklab_tpu.wrappers.dataset.synthetic import \
    make_synthetic_set as jmake_set
from tracklab_tpu.wrappers.jersey import ocr_api as JOCR
from tracklab_torch import main as TM
from tracklab_torch.eval import gs_evaluator as TGE
from tracklab_torch.eval.gs_metrics import make_gs_sequence_data
from tracklab_torch.eval.metrics import hota_metrics
from tracklab_torch.models.convert import osnet_from_flax
from tracklab_torch.wrappers import calibration_api as TAPI
from tracklab_torch.wrappers.dataset import soccernet as TSN
from tracklab_torch.wrappers.dataset.synthetic import make_synthetic_set
from tracklab_torch.wrappers.jersey import ocr_api as TOCR

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

W, H = 640, 360


def _assert_frames_equal(got, want, atol=0.0):
    """Same index and columns; arrays, dicts of arrays and floats equal
    within ``atol`` and, where ``atol`` is given, 1e-5 relative (the
    game-state geometry: the port draws it in f32, JAX here in f64 as the
    suite enables x64; a box near the horizon lands ~3 km out)."""
    rtol = 1e-5 if atol else 0.0
    pd.testing.assert_index_equal(got.index, want.index)
    assert list(got.columns) == list(want.columns)
    for col in want.columns:
        for g, w in zip(got[col], want[col]):
            if isinstance(w, dict):
                assert list(g) == list(w), col
                for k in w:
                    np.testing.assert_allclose(g[k], w[k], rtol=rtol,
                                               atol=atol, err_msg=col)
            elif isinstance(w, (np.ndarray, float)):
                np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                           err_msg=col)
            else:
                assert g == w or (pd.isna(g) and pd.isna(w)), (col, g, w)


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
    ["+experiment=mot17_ocsort"],
    ["+experiment=mot17_ocsort", "modules/bbox_detector=yolo11"],
    ["+experiment=soccernet_gamestate", "data_dir=/somewhere"],
    ["dataset=soccernet_mot", "eval=gs_hota", "+modules/calibration=pitch_seg",
     "pipeline=[calibration]"],
    ["+modules/calibration=pitch_projection", "pipeline=[calibration]"],
], ids=["mot17", "mot17-yolo11", "gamestate", "snmot-pitchseg",
        "projection"])
def test_compose_matches_jax(overrides):
    """The slice's config groups compose as the JAX package's do."""
    from tracklab_torch.config import compose as tcompose
    got = tcompose(TM.CONFIG_DIR, "config", overrides)
    want = jcompose(JM.CONFIG_DIR, "config", overrides)
    assert got["device"] == "cuda"
    assert _as_jax_targets(got) == {k: v for k, v in want.items()
                                    if k != "device"}


def test_game_state_set_matches_jax():
    kw = dict(n_videos=2, n_frames=6, n_objects=4, seed=2, img_w=W, img_h=H,
              with_keypoints=True, game_state=True, det_noise=1.0)
    got, want = make_synthetic_set(**kw), jmake_set(**kw)
    _assert_frames_equal(got.video_metadatas, want.video_metadatas)
    # pixels within 1e-3 px, pitch metres within 1e-3 m
    _assert_frames_equal(got.image_metadatas, want.image_metadatas,
                         atol=1e-3)
    _assert_frames_equal(got.detections_gt, want.detections_gt, atol=1e-3)
    assert got.image_metadatas["pitch_lines"].map(len).min() >= 4
    assert got.detections_gt["team"].tolist()[:2] == ["left", "right"]


def _gs_tree(root):
    """tests/test_soccernet.py's GS video in valid, a second one there with
    an annotation that is not an object, and one in train."""
    make_gs_video(root)
    src = root / "valid" / "SNGS-001"
    for split, name in (("valid", "SNGS-002"), ("train", "SNGS-000")):
        dst = root / split / name
        (dst / "img1").mkdir(parents=True)
        data = json.loads((src / "Labels-GameState.json").read_text())
        data["annotations"].append({"id": "p", "image_id": "1000",
                                    "supercategory": "pitch"})
        (dst / "Labels-GameState.json").write_text(json.dumps(data))
    return root


def test_soccernet_gs_loader_and_export_match_jax(tmp_path):
    _gs_tree(tmp_path / "data")
    got = TSN.SoccerNetGameState(str(tmp_path / "data"))
    want = JSN.SoccerNetGameState(str(tmp_path / "data"))
    assert list(got.sets) == list(want.sets) == ["train", "valid"]
    for split in want.sets:
        for name in ("video_metadatas", "image_metadatas", "detections_gt",
                     "image_gt"):
            _assert_frames_equal(getattr(got.sets[split], name),
                                 getattr(want.sets[split], name))
    ts = got.sets["valid"]
    pred = ts.detections_gt.copy()
    pred.loc[pred.index[0], "bbox_pitch"] = np.nan
    for pkg, cls in (("torch", TSN.SoccerNetGameState),
                     ("jax", JSN.SoccerNetGameState)):
        cls.save_for_eval(pred, ts.image_metadatas, ts.video_metadatas,
                          str(tmp_path / pkg / "pred"))
    for name in ("SNGS-001.json", "SNGS-002.json"):
        got_j = json.loads((tmp_path / "torch" / "pred" / name).read_text())
        assert got_j == json.loads(
            (tmp_path / "jax" / "pred" / name).read_text())
        assert len(got_j["predictions"]) == 8
    with zipfile.ZipFile(tmp_path / "torch" / "pred.zip") as z:
        assert z.namelist() == ["pred/SNGS-001.json", "pred/SNGS-002.json"]
    res = {"COMBINED_SEQ": {"HOTA": 61.5}}
    assert got.process_trackeval_results(dict(res)) == \
        want.process_trackeval_results(dict(res))
    assert TSN.SoccerNetMOT.splits == JSN.SoccerNetMOT.splits
    with pytest.raises(ImportError, match="SoccerNet"):
        TSN.download_dataset(tmp_path / "nowhere")


@pytest.mark.parametrize("gating", [(True, True, True), (True, False, True),
                                    (False, False, False)],
                         ids=["all", "no-teams", "none"])
@pytest.mark.parametrize("seed", [0, 1])
def test_gs_hota_matches_jax_and_oracle(seed, gating):
    gt, pred = random_stream(np.random.default_rng(seed))
    got = hota_metrics(make_gs_sequence_data(gt, pred, 5.0, *gating))
    want = jhota(jmake_gs_data(gt, pred, 5.0, *gating))
    oracle = gs_hota_oracle(gt, pred, 5.0, *gating)
    assert 0 < want["HOTA"] < 100
    for k in ("HOTA", "DetA", "AssA", "LocA"):
        assert got[k] == want[k], k
        assert abs(got[k] - oracle[k]) < 1e-9, k
    for k in ("HOTA_TP", "HOTA_FN", "HOTA_FP", "AssA_num"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _noisy_game_state():
    gt = make_synthetic_set(n_videos=2, n_frames=10, n_objects=5, seed=3,
                            img_w=W, img_h=H, game_state=True)
    pred = gt.detections_gt.copy()
    rng = np.random.default_rng(0)
    pred["bbox_pitch"] = [
        {k: v + rng.normal(0, 2.0) for k, v in bp.items()}
        for bp in pred["bbox_pitch"]]
    pred.loc[pred["track_id"] == 2, "team"] = "left"
    pred.loc[pred.index[::7], "jersey_number"] = None
    pred = pred.drop(index=pred.index[::5])
    pred["bbox_ltwh"] = [b + rng.normal(0, 3.0, 4).astype(np.float32)
                         for b in pred["bbox_ltwh"]]
    return gt, pred


def test_game_state_evaluator_and_accuracy_match_jax():
    gt, pred = _noisy_game_state()
    state = type("S", (), dict(image_metadatas=gt.image_metadatas,
                               video_metadatas=gt.video_metadatas,
                               detections_gt=gt.detections_gt,
                               detections_pred=pred))()
    for kw in ({}, dict(use_teams=False, dist_tol=3.0)):
        got = TGE.GameStateEvaluator(num_parallel=2, **kw).run(state)
        want = JGE.GameStateEvaluator(num_parallel=2, **kw).run(state)
        assert 0 < want["COMBINED_SEQ"]["GS-HOTA"] < 100
        assert got["per_seq"].keys() == want["per_seq"].keys()
        for k, v in want["COMBINED_SEQ"].items():
            np.testing.assert_allclose(got["COMBINED_SEQ"][k], v, rtol=0,
                                       atol=1e-12, err_msg=k)
    got = TGE.SoccerAccuracy().run(state)
    want = JGE.SoccerAccuracy().run(state)
    assert got == want and 0 < want["team_accuracy"] < 100


def test_jersey_ocr_without_easyocr_matches_jax(monkeypatch):
    """Where easyocr cannot be imported both modules emit no number and
    confidence 0 for every crop; the torso-band mapping of readings is the
    JAX package's."""
    import sys
    monkeypatch.setitem(sys.modules, "easyocr", None)
    dets = pd.DataFrame({"bbox_ltwh": [np.array([1, 2, 30, 60.0])] * 3},
                        index=[4, 5, 6])
    crops = {"crop": [np.zeros((60, 30, 3), np.uint8)] * 2
             + [np.zeros((0, 0, 3), np.uint8)]}
    got = TOCR.JerseyNumberOCR(device="cpu").process(crops, dets, None)
    want = JOCR.JerseyNumberOCR().process(crops, dets, None)
    pd.testing.assert_frame_equal(got, want)
    assert got["jersey_number_detection"].isna().all()
    readings = [([(5, 5), (25, 5), (25, 20), (5, 20)], "1O", 0.9),
                ([(5, 8), (25, 8), (25, 22), (5, 22)], "17", 0.6),
                ([(5, 50), (25, 50), (25, 58), (5, 58)], "8", 0.99),
                ([(5, 8), (25, 8), (25, 22), (5, 22)], "123", 0.95)]
    for res in (readings, readings[2:], None):
        assert TOCR.map_ocr_to_jersey(res, (60, 30)) == \
            JOCR.map_ocr_to_jersey(res, (60, 30))


def test_config4_as_typed_calibrates_nothing(tmp_path):
    """The reference fault kept: soccernet_gamestate.yaml's pipeline has no
    pitch-line step and the GS loader gives image rows no ``pitch_lines``
    and no ``parameters``, so TVCalibration emits no row, PitchProjection
    gives no detection a ``bbox_pitch`` and GS-HOTA is 0, in both
    packages."""
    make_gs_video(tmp_path)
    results = {}
    for pkg, SN, API, GE, kw in (
            ("jax", JSN, JAPI, JGE, {}),
            ("torch", TSN, TAPI, TGE, dict(device="cpu"))):
        ts = SN.SoccerNetGameState(str(tmp_path)).sets["valid"]
        images = ts.image_metadatas
        cal = API.TVCalibration(**kw)
        batch = {"pitch_lines": [
            cal.preprocess(None, None, md)["pitch_lines"].value
            for _, md in images.iterrows()]}
        _, rows = cal.process(batch, None, images)
        assert rows == [], pkg
        pred = ts.detections_gt.drop(columns=["bbox_pitch"])
        proj = API.PitchProjection(**kw).process(pred, images)
        assert proj["bbox_pitch"].isna().all(), pkg
        pred["bbox_pitch"] = proj["bbox_pitch"]
        state = type("S", (), dict(image_metadatas=images,
                                   video_metadatas=ts.video_metadatas,
                                   detections_gt=ts.detections_gt,
                                   detections_pred=pred))()
        results[pkg] = GE.GameStateEvaluator(num_parallel=1).run(state)
    for res in results.values():
        assert res["COMBINED_SEQ"]["GS-HOTA"] == 0.0


# -------------------------------------------------- the game-state chain
GS_BOOTSTRAP = (
    "state.load_from_groundtruth={detection: [bbox_ltwh, bbox_conf, "
    "category_id, team_detection, team_confidence, role_detection, "
    "role_confidence, jersey_number_detection, jersey_number_confidence]}")
OSNET = dict(variant="x0_25", feat_dim=64, n_parts=2)


def _chain(pkg):
    """tests/test_gsr_pipeline.py's configuration with OSNet x0_25 on
    64 x 32 host crops and StrongSORT in place of KPR and
    BPBReID-StrongSORT."""
    return [
        "dataset.n_videos=1", "dataset.n_frames=12", "dataset.n_objects=4",
        f"dataset.img_w={W}", f"dataset.img_h={H}",
        "+dataset.game_state=true",
        "pipeline=[reid, track, jersey, vote, calibration, projection]",
        "modules/reid=osnet", "modules.reid.variant=x0_25",
        "modules.reid.feat_dim=64", "modules.reid.n_parts=2",
        "modules.reid.crop_size=[64,32]", "modules.reid.batch_size=16",
        "modules/track=strong_sort", "modules.track.embed_dim=64",
        "modules.track.n_init=1", "modules.track.max_tracks=16",
        "modules.track.max_dets=8",
        f"+modules.jersey._target_={pkg}.wrappers.jersey.JerseyNumberOCR",
        f"+modules.vote._target_={pkg}.wrappers.tracklet_agg."
        "MajorityVoteTracklet",
        "+modules.vote.attributes=[team, role, jersey_number]",
        "modules/calibration=tvcalib",
        f"modules.calibration.image_width={W}",
        f"modules.calibration.image_height={H}",
        "modules.calibration.steps=200",
        f"+modules.projection._target_={pkg}.wrappers.calibration_api."
        "PitchProjection",
        f"+modules.projection.image_width={W}",
        f"+modules.projection.image_height={H}",
        "eval=gs_hota", "eval.use_jerseys=false", GS_BOOTSTRAP,
        "use_rich=false", "num_cores=1"]


def _osnet_variables():
    shapes = jax.eval_shape(lambda: JOSNet(**OSNET).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 32, 3)), train=False))
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


def test_game_state_chain_matches_jax(tmp_path):
    """Both CLIs on the same bootstrap and OSNet weights: the same rows,
    track ids and voted team/role; the cameras within the calibration
    test's bounds (x10 for 200 steps), both GS-HOTA above 80 as
    tests/test_gsr_pipeline.py requires, within 0.5 of each other."""
    variables = _osnet_variables()
    ckpt = tmp_path / "osnet.pt"
    torch.save(osnet_from_flax(jax.tree_util.tree_map(np.asarray, variables),
                               n_parts=2, device="cpu").state_dict(), ckpt)
    cfg = jcompose(JM.CONFIG_DIR, "config", _chain("tracklab_tpu"))
    JM.init_environment(cfg)
    jparts = JM.build(cfg)
    jparts["modules"][0].variables = variables
    jparts["engine"].track_dataset()
    jres = JM.evaluate(cfg, jparts["evaluator"], jparts["tracker_state"])
    tparts, tres = TM.main(_chain("tracklab_torch") + [
        "device=cpu", f"modules.reid.checkpoint_path={ckpt}"])
    want = jparts["tracker_state"].detections_pred
    got = tparts["tracker_state"].detections_pred
    pd.testing.assert_index_equal(got.index, want.index)
    for col in ("track_id", "team", "role"):     # NaN before a track's birth
        assert got[col].fillna(-1).tolist() == want[col].fillna(-1).tolist()
    assert got["track_id"].notna().sum() > 0
    assert "jersey_number_detection" in got.columns
    pj = jparts["tracker_state"].image_pred["parameters"].dropna()
    pt = tparts["tracker_state"].image_pred["parameters"].dropna()
    assert len(pt) == len(pj) == 12
    for g, w in zip(pt, pj):
        assert g["camera_type"] == w["camera_type"]
        assert g["relative_mean_reproj"] < 0.01
        for k in ("pan_degrees", "tilt_degrees", "roll_degrees"):
            assert abs(g[k] - w[k]) <= 1.0, (k, g[k], w[k])
    for res in (jres, tres):
        assert res["COMBINED_SEQ"]["GS-HOTA"] > 80.0
    assert abs(tres["COMBINED_SEQ"]["GS-HOTA"]
               - jres["COMBINED_SEQ"]["GS-HOTA"]) <= 0.5
