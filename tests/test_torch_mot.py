"""The port's MOT-format datasets against the JAX package's on the CPU, on
tests/test_mot_dataset.py's trees: metadata, ground truth, public
detections, nvid/nframes, the save_for_eval text, a tree with three splits,
the public-detection bootstrap, and the DanceTrack experiment end to end on
a tree of PNG frames."""
import cv2
import numpy as np
import pandas as pd
import pytest
import torch

from test_mot_dataset import make_mot_dir
from tracklab_tpu.wrappers.dataset import mot_like as JMOT
from tracklab_torch import main as TM
from tracklab_torch.wrappers.dataset import mot_like as TMOT

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

NAMES = ["MOT", "MOT17", "MOT20", "DanceTrack", "SportsMOT", "Bee24"]


def _assert_frames_equal(got, want):
    pd.testing.assert_index_equal(got.index, want.index)
    assert list(got.columns) == list(want.columns)
    for col in want.columns:
        np.testing.assert_equal(list(got[col]), list(want[col]),
                                err_msg=col)


def _assert_sets_equal(got, want, public=True):
    for name in ("video_metadatas", "image_metadatas", "detections_gt",
                 "image_gt"):
        _assert_frames_equal(getattr(got, name), getattr(want, name))
    if public:
        _assert_frames_equal(got.detections_public, want.detections_public)


@pytest.mark.parametrize("name", NAMES)
def test_mot_loader_matches_jax(tmp_path, name):
    make_mot_dir(tmp_path, n_videos=2, n_frames=5)
    got = getattr(TMOT, name)(str(tmp_path), public_dets=True)
    want = getattr(JMOT, name)(str(tmp_path), public_dets=True)
    for attr in ("name", "nickname", "splits", "categories"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert list(got.sets) == list(want.sets) == ["train"]
    _assert_sets_equal(got.sets["train"], want.sets["train"])
    assert len(got.sets["train"].detections_public) == 20


def test_nvid_nframes_match_jax(tmp_path):
    """Subsampling keeps the JAX package's rows. The port also keeps the
    image rows' video_id (the JAX package's groupby.apply drops that column
    under pandas 3, and its TrackerState then fails to load a video) and
    the public detections of the kept frames (the JAX package drops
    them)."""
    make_mot_dir(tmp_path, n_videos=3, n_frames=6)
    kw = dict(nvid=2, nframes=3, public_dets=True)
    got = TMOT.MOT17(str(tmp_path), **kw).sets["train"]
    want = JMOT.MOT17(str(tmp_path), **kw).sets["train"]
    for name in ("video_metadatas", "detections_gt", "image_gt"):
        _assert_frames_equal(getattr(got, name), getattr(want, name))
    images = got.image_metadatas
    _assert_frames_equal(images[[c for c in images.columns
                                 if c in want.image_metadatas.columns]],
                         want.image_metadatas)
    np.testing.assert_array_equal(images["video_id"], [0, 0, 0, 1, 1, 1])
    assert not hasattr(want, "detections_public")
    full = TMOT.MOT17(str(tmp_path), public_dets=True).sets["train"]
    pub = full.detections_public
    _assert_frames_equal(got.detections_public,
                         pub[pub["image_id"].isin(got.image_metadatas.index)])


def test_save_for_eval_matches_jax(tmp_path):
    make_mot_dir(tmp_path / "data", n_videos=2, n_frames=5)
    ts = TMOT.MOT17(str(tmp_path / "data")).sets["train"]
    export = ts.detections_gt.copy()
    export["bbox_conf"] = 0.75
    args = (export, ts.image_metadatas, ts.video_metadatas)
    TMOT.MOT17.save_for_eval(*args, str(tmp_path / "torch" / "pred"))
    JMOT.MOT17.save_for_eval(*args, str(tmp_path / "jax" / "pred"))
    for rel in ("pred/MOT17-00.txt", "pred/MOT17-01.txt", "seqmaps.txt"):
        got = (tmp_path / "torch" / rel).read_text()
        assert got == (tmp_path / "jax" / rel).read_text(), rel
    assert len(got.splitlines()) == 3


def _three_splits(root):
    """test_mot_dataset.py's tree in train, val and test, with other
    sequence counts and lengths per split."""
    for split, (n_videos, n_frames) in zip(("train", "val", "test"),
                                           ((2, 5), (1, 4), (3, 3))):
        make_mot_dir(root / split, n_videos=n_videos, n_frames=n_frames)
        for seq in (root / split / "train").iterdir():
            seq.rename(root / split / f"{split}-{seq.name}")
        (root / split / "train").rmdir()


def _keyed(ts):
    """A set's content keyed by sequence name and frame (and track id), so
    that sets whose integer ids were counted in another order compare."""
    videos = ts.video_metadatas["name"]
    images = ts.image_metadatas.assign(seq=lambda d: videos[d["video_id"]]
                                       .to_numpy())
    key = images[["seq", "frame"]]

    def rows(dets):
        d = dets.assign(seq=key.loc[dets["image_id"], "seq"].to_numpy())
        by = ["seq", "frame"] + (["track_id"] if "track_id" in d else [])
        cols = [c for c in d.columns if c not in ("image_id", "video_id")]
        d = d[cols].sort_values(by + ["bbox_conf"]).reset_index(drop=True)
        d["bbox_ltwh"] = [tuple(b) for b in d["bbox_ltwh"]]
        return d

    return (ts.video_metadatas.set_index("name").sort_index(),
            images.set_index(["seq", "frame"]).drop(columns="video_id")
            .sort_index(), rows(ts.detections_gt),
            rows(ts.detections_public))


def test_three_splits_match_jax_content(tmp_path):
    """With three splits the JAX loader counts ids on three threads that
    share one counter, so its ids depend on their timing; the port reads
    the splits in order. The content agrees per split, keyed by sequence,
    frame and track; the port's ids are the single-threaded count."""
    _three_splits(tmp_path)
    got = TMOT.DanceTrack(str(tmp_path), public_dets=True)
    want = JMOT.DanceTrack(str(tmp_path), public_dets=True)
    assert list(got.sets) == ["train", "val", "test"]
    assert set(want.sets) == set(got.sets)
    for split in got.sets:
        g, w = _keyed(got.sets[split]), _keyed(want.sets[split])
        for a, b in zip(g, w):
            pd.testing.assert_frame_equal(a, b)
    counts = [(len(s.video_metadatas), len(s.image_metadatas),
               len(s.detections_gt) + len(s.detections_public))
              for s in got.sets.values()]
    starts = np.cumsum([(0, 0, 0)] + counts[:-1], axis=0)
    for (v0, i0, d0), s in zip(starts, got.sets.values()):
        assert s.video_metadatas.index[0] == v0
        assert s.image_metadatas.index[0] == i0
        assert s.detections_gt.index[0] == d0


def test_public_dets_pipeline(tmp_path):
    """load_from_public_dets bootstraps OC-SORT without a detector
    (tests/test_mot_dataset.py's test of the JAX package)."""
    from tracklab_torch.datastruct.tracker_state import TrackerState
    from tracklab_torch.engine import OfflineTrackingEngine
    from tracklab_torch.pipeline.module import Pipeline
    from tracklab_torch.wrappers.track import OCSORT
    make_mot_dir(tmp_path, n_videos=1, n_frames=5)
    ts = TMOT.MOT17(str(tmp_path), public_dets=True).sets["train"]
    tracker = OCSORT(min_hits=1, det_thresh=0.4, max_dets=8, max_tracks=8,
                     device="cpu")
    state = TrackerState(ts, Pipeline([tracker]), load_from_public_dets=True)
    OfflineTrackingEngine(tracker_state=state, modules=[tracker],
                          callbacks=[], device="cpu").track_dataset()
    dets = state.detections_pred
    assert dets["track_id"].notna().sum() >= 8
    assert dets["track_id"].dropna().nunique() == 2
    with pytest.raises(ValueError, match="public"):
        TrackerState(TMOT.MOT17(str(tmp_path)).sets["train"],
                     load_from_public_dets=True)


def _png_tree(root, n_frames=6, size=(96, 128)):
    """A DanceTrack-layout val split: one sequence of PNG frames with three
    moving blocks on a ramp, and their boxes as gt.txt."""
    seq = root / "DanceTrack" / "val" / "dancetrack0001"
    (seq / "img1").mkdir(parents=True)
    (seq / "gt").mkdir()
    h, w = size
    (seq / "seqinfo.ini").write_text(
        f"[Sequence]\nname={seq.name}\nimDir=img1\nframeRate=20\n"
        f"seqLength={n_frames}\nimWidth={w}\nimHeight={h}\nimExt=.png\n")
    ramp = np.linspace(20, 90, w, dtype=np.float32)[None, :, None]
    gt = []
    for f in range(1, n_frames + 1):
        img = np.broadcast_to(ramp, (h, w, 3)).astype(np.uint8).copy()
        for t in range(3):
            x, y = 10 + 35 * t + 2 * f, 20 + 10 * t
            img[y:y + 40, x:x + 20] = (200 - 50 * t, 60 + 60 * t, 120)
            gt.append(f"{f},{t + 1},{x},{y},20,40,1,1,1.0")
        cv2.imwrite(str(seq / "img1" / f"{f:06d}.png"), img[..., ::-1])
    (seq / "gt" / "gt.txt").write_text("\n".join(gt) + "\n")
    return root


def test_dancetrack_experiment_runs_on_the_cpu(tmp_path):
    """``+experiment=dancetrack_strongsort`` on PNG frames with device=cpu,
    the widths cut (YOLOX-nano at 128, OSNet x0_25 on 96 x 32 crops) and
    the detector's and tracker's thresholds at 0 for random weights: every
    frame is read from disk, every detection embedded on host crops, every
    row tracked and evaluated."""
    data = _png_tree(tmp_path)
    parts, res = TM.main([
        "+experiment=dancetrack_strongsort", f"data_dir={data}",
        "device=cpu", "use_rich=false", "num_cores=2",
        "modules.bbox_detector.variant=nano",
        "modules.bbox_detector.input_size=[128,128]",
        "modules.bbox_detector.min_confidence=0.0",
        "modules.bbox_detector.max_dets=8",
        "modules.bbox_detector.batch_size=4",
        "modules.reid.variant=x0_25", "modules.reid.feat_dim=32",
        "modules.reid.crop_size=[96,32]", "modules.reid.batch_size=16",
        "modules.track.min_confidence=0.0", "modules.track.embed_dim=32",
        "modules.track.max_dets=8", "modules.track.max_tracks=16",
        "modules.track.n_init=1"])
    pred = parts["tracker_state"].detections_pred
    assert 0 < len(pred) <= 6 * 8
    emb = np.stack(pred["embeddings"].to_numpy())
    assert emb.shape == (len(pred), 7, 32) and np.isfinite(emb).all()
    assert pred["track_id"].notna().sum() > 0
    assert 0.0 <= res["COMBINED_SEQ"]["HOTA"] <= 100.0
