"""The port's host utilities against the JAX package on the CPU:
person-disjoint set splits (``split_set``, ``set_split_idxs``) on
tests/test_dataset_splits.py's set, the COCO-JSON detection bootstrap of
``TrackerState``, the wandb adapter (a no-op without wandb, and with a
stand-in module), the checkpoint download with the fetch faked, and the
SoccerNet baseline calibration on the synthetic game-state chain's pitch
lines (its latents warm-starting ``optimize_cameras``)."""
import hashlib
import json
import sys
import types
import urllib.request

import numpy as np
import pandas as pd
import pytest
import torch

from test_dataset_splits import make_multi_video_set
from tracklab_tpu.calibration import sn_baseline as JSB
from tracklab_tpu.datastruct import tracking_dataset as JDS
from tracklab_tpu.datastruct.tracker_state import TrackerState as JState
from tracklab_tpu.utils import download as JDL
from tracklab_tpu.utils import wandb as JWB
from tracklab_torch.calibration import sn_baseline as TSB
from tracklab_torch.calibration.cam_distr import priors_array
from tracklab_torch.calibration.tvcalib import (TVCalibConfig,
                                                optimize_cameras)
from tracklab_torch.datastruct import tracking_dataset as TDS
from tracklab_torch.datastruct.tracker_state import TrackerState as TState
from tracklab_torch.utils import download as TDL
from tracklab_torch.utils import wandb as TWB
from tracklab_torch.wrappers.dataset.synthetic import make_synthetic_set

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)


def _port_set(jset):
    return TDS.TrackingSet(jset.video_metadatas.copy(),
                           jset.image_metadatas.copy(),
                           jset.detections_gt.copy())


def _same_set(got, want):
    for name in ("video_metadatas", "image_metadatas", "detections_gt",
                 "image_gt"):
        pd.testing.assert_frame_equal(getattr(got, name),
                                      getattr(want, name), obj=name)


@pytest.mark.parametrize("column", ["person_id", "track_id"])
def test_split_set_matches_jax(tmp_path, column):
    """Both halves of the two-way person-disjoint split equal JAX's, with
    ``person_id`` and with ``track_id`` standing in (the column dropped);
    the halves share no identity and cover every video."""
    jset = make_multi_video_set()
    if column == "track_id":
        jset.detections_gt = jset.detections_gt.drop(columns="person_id")
    want = JDS.TrackingDataset(str(tmp_path), {"train": jset}).split_set(
        "train")
    got = TDS.TrackingDataset(str(tmp_path), {"train": _port_set(jset)}) \
        .split_set("train")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _same_set(g, w)
    ids = [set(h.detections_gt[column]) for h in got]
    assert not ids[0] & ids[1]
    assert set(got[0].video_metadatas.index) | set(
        got[1].video_metadatas.index) == set(range(6))


@pytest.mark.parametrize("half", [0, 1])
def test_set_split_idxs_selects_jax_half(tmp_path, half):
    """F6: ``TrackingDataset(set_split_idxs={"train": half})`` replaces the
    set by JAX's half, and keeps both halves in ``set_splits``."""
    kw = dict(set_split_idxs={"train": half})
    want = JDS.TrackingDataset(str(tmp_path), {
        "train": make_multi_video_set()}, **kw)
    got = TDS.TrackingDataset(str(tmp_path), {
        "train": _port_set(make_multi_video_set())}, **kw)
    _same_set(got.sets["train"], want.sets["train"])
    assert len(got.sets["train"].video_metadatas) < 6
    assert got.set_split_idxs == {"train": half}
    for g, w in zip(got.set_splits["train"], want.set_splits["train"]):
        _same_set(g, w)


def _coco_json(path, image_ids):
    """COCO-style detections: a dict holding them under ``annotations``;
    records of an unknown image, with keypoints, without score or
    category."""
    rng = np.random.default_rng(9)
    recs = []
    for i in list(image_ids) + [99999]:
        for k in range(2):
            rec = {"image_id": int(i),
                   "bbox": rng.uniform(0, 100, 4).round(3).tolist()}
            if k == 0:
                rec["score"] = float(rng.uniform())
                rec["category_id"] = 2
                rec["keypoints"] = rng.uniform(0, 50, 51).round(2).tolist()
            recs.append(rec)
    path.write_text(json.dumps({"annotations": recs}))
    return path


def test_json_bootstrap_matches_jax(tmp_path):
    """``TrackerState(json_file=...)``: the detections read, the columns
    loaded and each video's ``load()`` equal JAX's."""
    jset = make_multi_video_set(n_videos=3, n_frames=2)
    path = _coco_json(tmp_path / "dets.json", jset.image_metadatas.index)
    want = JState(jset, json_file=str(path))
    got = TState(_port_set(jset), json_file=str(path))
    pd.testing.assert_frame_equal(got.json_detections_pred,
                                  want.json_detections_pred)
    assert len(got.json_detections_pred) == 2 * len(jset.image_metadatas)
    assert got.load_columns == want.load_columns
    for vid in jset.video_metadatas.index:
        with got(vid) as g, want(vid) as w:
            gd, gi = g.load()
            wd, wi = w.load()
        pd.testing.assert_frame_equal(gd, wd)
        pd.testing.assert_frame_equal(gi, wi)
    pd.testing.assert_frame_equal(got.detections_pred, want.detections_pred)


class _FakeRun:
    def __init__(self):
        self.logged = []
        self.finished = False

    def log(self, d):
        self.logged.append(d)

    def finish(self):
        self.finished = True


def test_wandb_is_a_no_op_without_wandb_and_logs_with_it(monkeypatch):
    """Without ``wandb`` every call does nothing (as here); with a stand-in
    module both adapters open the same run config and log the same numeric
    values."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    assert TWB.init({"a": 1}) is None
    TWB.log_metrics({"HOTA": 50.0})
    TWB.finish()
    runs = {}

    def fake_init(project=None, name=None, config=None):
        run = _FakeRun()
        runs.setdefault("calls", []).append((project, name, config))
        return run

    monkeypatch.setitem(sys.modules, "wandb",
                        types.SimpleNamespace(init=fake_init))
    cfg = {"experiment_name": "exp", "dataset": {"nvid": 2}}
    metrics = {"HOTA": 61.5, "per": {"DetA": 2, "name": "x"}}
    logged = []
    for wb in (JWB, TWB):
        run = wb.init(cfg)
        wb.log_metrics(metrics, prefix="eval")
        logged.append(run.logged)
        wb.finish()
        assert run.finished and wb._run is None
    assert logged[0] == logged[1] == [{"eval.HOTA": 61.5,
                                       "eval.per.DetA": 2}]
    assert runs["calls"][0] == runs["calls"][1] == (
        "exp", None, {"experiment_name": "exp", "dataset.nvid": 2})


def test_evaluator_logs_through_wandb(monkeypatch):
    """The port's evaluator hands its combined and per-sequence numbers
    to the adapter, as JAX's does (``eval/evaluator.py``)."""
    from tracklab_torch.eval.evaluator import TrackEvalEvaluator
    from tracklab_torch.main import main
    seen = []
    monkeypatch.setattr(TWB, "log_metrics",
                        lambda m, prefix="": seen.append(prefix))
    parts, results = main([
        "device=cpu", "dataset.n_videos=1", "dataset.n_frames=6",
        "dataset.n_objects=2", "use_rich=false",
        "state.load_from_groundtruth={detection: [bbox_ltwh, bbox_conf, "
        "category_id]}"])
    assert isinstance(parts["evaluator"], TrackEvalEvaluator)
    assert results["COMBINED_SEQ"]["HOTA"] > 0
    assert seen[0] == "eval" and seen[1].startswith("eval/")


@pytest.fixture
def fake_fetch(monkeypatch):
    """``urllib.request.urlretrieve`` writing a URL's bytes from a table,
    counting the calls; nothing goes to the network."""
    served = {"calls": 0, "files": {}}

    def urlretrieve(url, dest):
        served["calls"] += 1
        with open(dest, "wb") as fp:
            fp.write(served["files"][url])
        return str(dest), None

    monkeypatch.setattr(urllib.request, "urlretrieve", urlretrieve)
    return served


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_download_with_the_fetch_faked(tmp_path, fake_fetch, package):
    """md5sum, download (fetched once, then served from disk while the md5
    holds), an md5 mismatch (raises, removes the file) and
    ``get_checkpoint`` (local path as it is, a URL cached by file name, a
    missing path raises), the same in both packages."""
    dl = {"jax": JDL, "torch": TDL}[package]
    data = b"weights" * 1000
    md5 = hashlib.md5(data).hexdigest()
    url = "https://example.invalid/models/osnet_x1_0.pth"
    fake_fetch["files"][url] = data
    dest = tmp_path / "cache" / "osnet.pth"
    assert dl.download_file(url, dest, md5) == dest
    assert dl.md5sum(dest) == md5 and fake_fetch["calls"] == 1
    dl.download_file(url, dest, md5)
    assert fake_fetch["calls"] == 1
    fake_fetch["files"][url + "2"] = b"corrupt"
    with pytest.raises(IOError, match="md5 mismatch"):
        dl.download_file(url + "2", tmp_path / "bad.pth", md5)
    assert not (tmp_path / "bad.pth").exists()
    got = dl.get_checkpoint(url, model_dir=tmp_path / "models", md5=md5)
    assert got == tmp_path / "models" / "osnet_x1_0.pth"
    assert dl.get_checkpoint(str(dest)) == dest
    with pytest.raises(FileNotFoundError):
        dl.get_checkpoint(str(tmp_path / "absent.pth"))


W, H = 640, 360


@pytest.fixture(scope="module")
def chain_lines():
    """The synthetic game-state chain's pitch lines (each video's camera
    panned, 0.5 px of noise): the frames' ``pitch_lines``."""
    ts = make_synthetic_set(n_videos=3, n_frames=2, n_objects=2, seed=4,
                            img_w=W, img_h=H, game_state=True)
    return list(ts.image_metadatas["pitch_lines"])


def test_sn_baseline_matches_jax(chain_lines):
    """Per frame of the chain: the homography (float64, within 1e-9 of
    JAX's), the camera from it (pan, tilt, roll, focal, position within
    1e-6 relative), its TVCalib latent and the evaluation of its
    projection (confusion, per-class counts, errors, summary) equal to
    JAX's; the baseline cameras reproject the lines to within 5 px (the
    lines carry 0.5 px of noise and the DLT fits them unweighted)."""
    from tracklab_torch.calibration.camera import project_points
    from tracklab_torch.calibration.pitch import pitch_segments
    cfg = TVCalibConfig(image_width=W, image_height=H)
    priors = priors_array(cfg.camera_types)[0]
    segs = pitch_segments()
    for obs in chain_lines:
        hj = JSB.estimate_homography_from_markings(obs)
        ht = TSB.estimate_homography_from_markings(obs)
        np.testing.assert_allclose(ht, hj, rtol=0, atol=1e-9)
        cj = JSB.camera_from_homography(hj, (W, H))
        ct = TSB.camera_from_homography(ht, (W, H))
        for field in ("pan", "tilt", "roll", "focal", "position",
                      "principal"):
            np.testing.assert_allclose(
                getattr(ct, field).numpy(), np.asarray(getattr(cj, field)),
                rtol=1e-6, atol=1e-9, err_msg=field)
        np.testing.assert_allclose(TSB.camera_to_latent(ct, priors, cfg),
                                   JSB.camera_to_latent(cj, priors, cfg),
                                   rtol=1e-6, atol=1e-9)
        projected = {}
        for name in obs:
            px, _ = project_points(ct, torch.tensor(segs[name]))
            projected[name] = px.numpy()
        projected["Circle central"] = np.zeros((3, 2))  # a false positive
        want = JSB.evaluate_camera_prediction(projected, obs, 5.0)
        got = TSB.evaluate_camera_prediction(projected, obs, 5.0)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1].keys() == want[1].keys() and got[2] == want[2]
        for k in want[1]:
            np.testing.assert_array_equal(got[1][k], want[1][k])
        summary = TSB.summarize_camera_eval(got[0], got[2])
        assert summary == JSB.summarize_camera_eval(want[0], want[2])
        assert summary["mean_reprojection_error"] < 5.0


def test_sn_baseline_warm_starts_tvcalib(chain_lines):
    """The baseline's latents as ``init_latents``: after 30 steps the
    reprojection error is below the default start's, on every frame."""
    cfg = TVCalibConfig(image_width=W, image_height=H, steps=30)
    priors = priors_array(cfg.camera_types)
    frames = chain_lines[:3]
    init = np.stack([[TSB.camera_to_latent(TSB.camera_from_homography(
        TSB.estimate_homography_from_markings(obs), (W, H)), priors[h], cfg)
        for obs in frames] for h in range(len(cfg.camera_types))])
    _, warm = optimize_cameras(frames, cfg, init_latents=init, device="cpu")
    _, cold = optimize_cameras(frames, cfg, device="cpu")
    assert (warm < cold).all() and np.isfinite(warm).all()
