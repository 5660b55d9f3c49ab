"""The port's batched, pipelined and online engines and their host layers,
on the CPU: the batched and pipelined engines against the port's offline
engine and JAX's engines of the same name (synthetic ground truth ->
OC-SORT), the pipelined engine with a detector against the staged offline
run and a failing stage, the online engine on an mp4 against JAX's
VideoOnlineTrackingEngine and against ``process`` over its own
detections, ExternalVideo's rows, the visualization engine's pixels,
IgnoredRegions, MajorityVoteTracklet, TorchProfiler and
``load_from_overrides``."""
import threading

import numpy as np
import pandas as pd
import pytest
import torch

from tracklab_torch import main as TM
from tracklab_torch.config import compose as tcompose
from tracklab_tpu import main as JM
from tracklab_tpu.config import compose as jcompose

# one intra-op thread per process: the suite runs in parallel workers
torch.set_num_threads(1)

GT = ("state.load_from_groundtruth="
      "{detection: [bbox_ltwh, bbox_conf, category_id]}")
QUICK = ["dataset.n_videos=4", "dataset.n_frames=20", "dataset.n_objects=5",
         GT, "use_rich=false"]


def _as_jax_targets(node):
    if isinstance(node, dict):
        return {k: (v.replace("tracklab_torch.", "tracklab_tpu.")
                    if k == "_target_" else _as_jax_targets(v))
                for k, v in node.items() if k != "device"}
    if isinstance(node, list):
        return [_as_jax_targets(v) for v in node]
    return node


@pytest.mark.parametrize("overrides", [
    ["+experiment=batched_8videos", "dataset.n_videos=8"],
    ["engine=pipelined", "visualization=save_videos"],
    ["engine=video", "dataset=external_video", "visualization=tracking"],
    ["+modules/tracklet_agg=majority_vote",
     "pipeline=[track,tracklet_agg]", "visualization=debug"],
], ids=["batched_8videos", "pipelined", "video", "tracklet_agg"])
def test_compose_matches_jax(overrides):
    got = tcompose(TM.CONFIG_DIR, "config", overrides)
    want = jcompose(JM.CONFIG_DIR, "config", overrides)
    assert _as_jax_targets(got) == {k: v for k, v in want.items()
                                    if k != "device"}


def _tracks(parts):
    return parts["tracker_state"].detections_pred.sort_index()


def _assert_tracks_equal(got, want, tag):
    pd.testing.assert_index_equal(got.index, want.index)
    np.testing.assert_array_equal(got["track_id"].to_numpy(float),
                                  want["track_id"].to_numpy(float),
                                  err_msg=tag)
    tv = want["track_id"].notna().to_numpy()
    assert tv.any(), f"{tag}: nothing tracked"
    np.testing.assert_allclose(
        np.stack(got["track_bbox_ltwh"].to_numpy()[tv]),
        np.stack(want["track_bbox_ltwh"].to_numpy()[tv]), rtol=0,
        atol=2.5e-4, err_msg=tag)


@pytest.fixture(scope="module")
def offline_run():
    return TM.main(QUICK + ["device=cpu"])


@pytest.mark.parametrize("engine", [
    ["+experiment=batched_8videos", "engine.video_batch_size=4"],
    ["engine=pipelined", "engine.chunk_size=8"],
], ids=["batched", "pipelined"])
def test_engine_matches_offline_and_jax(offline_run, engine):
    """4 videos x 20 frames of synthetic GT -> OC-SORT: the batched engine
    (the 4 videos at once) or the pipelined engine (chunks of 8) gives the
    offline engine's tracks, and JAX's engine of that name's."""
    parts, res = TM.main(QUICK + engine + ["device=cpu"])
    assert type(parts["engine"]).__name__ == type(
        JM.build(jcompose(JM.CONFIG_DIR, "config", QUICK + engine))
        ["engine"]).__name__
    assert res["COMBINED_SEQ"]["HOTA"] == 100.0
    _assert_tracks_equal(_tracks(parts), _tracks(offline_run[0]),
                         "vs the offline engine")
    jparts, jres = JM.run(jcompose(JM.CONFIG_DIR, "config", QUICK + engine))
    _assert_tracks_equal(_tracks(parts), _tracks(jparts), "vs JAX")
    assert jres["COMBINED_SEQ"]["HOTA"] == res["COMBINED_SEQ"]["HOTA"]


def test_batched_engine_over_uneven_batches(offline_run):
    """Batches of 3 videos, then 1: the offline engine's tracks."""
    parts, _ = TM.main(QUICK + ["+experiment=batched_8videos",
                                "engine.video_batch_size=3", "device=cpu"])
    _assert_tracks_equal(_tracks(parts), _tracks(offline_run[0]),
                         "batches of 3 and 1 vs the offline engine")


def test_batched_engine_mesh_is_not_ported():
    cfg = tcompose(TM.CONFIG_DIR, "config", QUICK + [
        "+experiment=batched_8videos", "engine.use_mesh=true",
        "device=cpu"])
    with pytest.raises(NotImplementedError, match="ROADMAP item 5"):
        TM.build(cfg, torch.device("cpu"))


DETECT = ["pipeline=[bbox_detector,track]", "+modules/bbox_detector=yolox",
          "modules.bbox_detector.variant=nano",
          "modules.bbox_detector.input_size=[128,128]",
          "modules.bbox_detector.min_confidence=0.25",
          "modules.bbox_detector.max_dets=16",
          "modules.bbox_detector.batch_size=2",
          "modules.track.min_confidence=0",
          "modules.track.det_thresh=0.253",
          "modules.track.max_dets=16", "modules.track.max_tracks=32",
          "dataset.n_videos=2", "dataset.n_frames=10", "dataset.n_objects=3",
          "dataset.img_w=128", "dataset.img_h=128", "use_rich=false",
          "device=cpu"]


def test_pipelined_detector_matches_staged():
    """Seeded YOLOX-nano 128 -> OC-SORT: chunks of 4 through the stage
    threads give the staged offline run's rows, row ids and tracks."""
    want = _tracks(TM.main(DETECT)[0])
    got = _tracks(TM.main(DETECT + ["engine=pipelined",
                                    "engine.chunk_size=4"])[0])
    _assert_tracks_equal(got, want, "pipelined vs staged")
    for col in ("image_id", "category_id", "bbox_conf"):
        np.testing.assert_array_equal(got[col].to_numpy(float),
                                      want[col].to_numpy(float))
    np.testing.assert_array_equal(np.stack(got["bbox_ltwh"].to_numpy()),
                                  np.stack(want["bbox_ltwh"].to_numpy()))


def test_pipelined_stage_failure_raises_without_hang():
    from tracklab_torch.datastruct.tracker_state import TrackerState
    from tracklab_torch.engine import PipelinedTrackingEngine
    from tracklab_torch.pipeline.levels import ImageLevelModule
    from tracklab_torch.pipeline.module import Pipeline
    from tracklab_torch.wrappers.dataset.synthetic import make_synthetic_set
    from tracklab_torch.wrappers.track import OCSORT

    class Boom(ImageLevelModule):
        input_columns = []
        output_columns = []

        def __init__(self):
            super().__init__(batch_size=2)

        def preprocess(self, image, detections, metadata):
            return {}

        def process(self, batch, detections, metadatas):
            raise RuntimeError("stage exploded")

    ts = make_synthetic_set(n_videos=1, n_frames=40, n_objects=2,
                            img_w=64, img_h=64)
    modules = [Boom(), OCSORT(device="cpu")]
    engine = PipelinedTrackingEngine(
        tracker_state=TrackerState(ts, Pipeline(modules)), modules=modules,
        chunk_size=2, queue_depth=1, device="cpu")
    raised = []

    def run():
        try:
            engine.track_dataset()
        except RuntimeError as e:
            raised.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "the pipelined engine hung on a failed stage"
    assert raised and "stage exploded" in str(raised[0])


# ---------------------------------------------------------- online engine
def _write_video(path, n_frames=20, size=(320, 240), second=None):
    """tests/test_aux.py's clip: a bright square moving on a dark
    background. With ``second`` (a frame number), a second, orange square
    moves the other way in the lower half, missing from that frame."""
    import cv2
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             size)
    for f in range(n_frames):
        img = np.full((size[1], size[0], 3), 20, np.uint8)
        img[60:120, 20 + 8 * f:60 + 8 * f] = 255
        if second is not None and f != second:
            img[150:210, 260 - 8 * f:300 - 8 * f] = (60, 140, 255)
        writer.write(img)
    writer.release()


def _modules(pkg):
    """A threshold detector (the box of the bright pixels in each half of
    the frame, top first), a detection-level module giving each row its
    crop's mean colour as an embedding, and StrongSORT, written against
    package ``pkg``'s module classes."""
    import importlib
    levels = importlib.import_module(f"{pkg}.pipeline.levels")
    collate = importlib.import_module(f"{pkg}.utils.collate")
    cv2u = importlib.import_module(f"{pkg}.utils.cv2")
    track = importlib.import_module(f"{pkg}.wrappers.track")

    class Bright(levels.ImageLevelModule):
        input_columns = []
        output_columns = ["image_id", "video_id", "category_id",
                          "bbox_ltwh", "bbox_conf"]

        def __init__(self):
            super().__init__(batch_size=1)
            self.id = 0

        def preprocess(self, image, detections, metadata):
            return {"image": collate.Unbatchable(image)}

        def process(self, batch, detections, metadatas):
            rows = []
            for image, (image_id, md) in zip(batch["image"],
                                             metadatas.iterrows()):
                half = image.shape[0] // 2
                for y0 in (0, half):
                    ys, xs = np.nonzero(image[y0:y0 + half, :, 0] > 128)
                    if not len(xs):
                        continue
                    ys = ys + y0
                    l, t = xs.min(), ys.min()
                    rows.append(pd.Series(dict(
                        image_id=image_id, video_id=md["video_id"],
                        category_id=1,
                        bbox_ltwh=np.array([l, t, xs.max() - l + 1,
                                            ys.max() - t + 1], np.float32),
                        bbox_conf=0.95), name=self.id))
                    self.id += 1
            return rows

    class Colour(levels.DetectionLevelModule):
        input_columns = ["bbox_ltwh"]
        output_columns = ["embeddings"]

        def __init__(self):
            super().__init__(batch_size=4)

        def preprocess(self, image, detection, metadata):
            crop = cv2u.crop_bbox(image, detection["bbox_ltwh"])
            return {"emb": np.concatenate([crop.mean((0, 1)),
                                           np.ones(5)]).astype(np.float32)}

        def process(self, batch, detections, metadatas):
            return pd.DataFrame({"embeddings": list(batch["emb"])},
                                index=detections.index)

    kw = dict(max_dets=8, max_tracks=8, embed_dim=8, n_init=1,
              min_confidence=0.0)
    if pkg == "tracklab_torch":
        kw["device"] = "cpu"
    return [Bright(), Colour(), track.StrongSORT(**kw)]


def _online(pkg, dataset):
    import importlib
    state_mod = importlib.import_module(f"{pkg}.datastruct.tracker_state")
    Pipeline = importlib.import_module(f"{pkg}.pipeline.module").Pipeline
    engines = importlib.import_module(f"{pkg}.engine")
    modules = _modules(pkg)
    state = state_mod.TrackerState(dataset.sets["val"], Pipeline(modules))
    kw = dict(device="cpu") if pkg == "tracklab_torch" else {}
    engine = engines.VideoOnlineTrackingEngine(
        tracker_state=state, modules=modules, callbacks=[], **kw)
    engine.track_dataset()
    return state, modules


def test_online_engine_on_a_file_matches_jax(tmp_path):
    from tracklab_torch.wrappers.dataset.external_video import ExternalVideo
    from tracklab_tpu.wrappers.dataset.external_video import \
        ExternalVideo as JExternalVideo

    _write_video(tmp_path / "clip.mp4")
    ds, jds = ExternalVideo(str(tmp_path)), JExternalVideo(str(tmp_path))
    for name in ("video_metadatas", "image_metadatas"):
        pd.testing.assert_frame_equal(getattr(ds.sets["val"], name),
                                      getattr(jds.sets["val"], name))
    state, modules = _online("tracklab_torch", ds)
    jstate, _ = _online("tracklab_tpu", jds)
    got, want = state.detections_pred, jstate.detections_pred
    assert len(got) == 20 and got["track_id"].nunique() == 1
    pd.testing.assert_index_equal(got.index, want.index)
    np.testing.assert_array_equal(np.stack(got["bbox_ltwh"].to_numpy()),
                                  np.stack(want["bbox_ltwh"].to_numpy()))
    np.testing.assert_allclose(np.stack(got["embeddings"].to_numpy()),
                               np.stack(want["embeddings"].to_numpy()),
                               rtol=1e-6)
    _assert_tracks_equal(got, want, "online vs JAX")
    pd.testing.assert_index_equal(state.image_pred.index,
                                  jstate.image_pred.index)
    _assert_tracks_equal_process(state, modules[-1])


def _assert_tracks_equal_process(state, tracker):
    """The online run's tracked rows are process()'s over the run's own
    detections: the same rows, ids and boxes. Returns (online rows,
    process()'s rows)."""
    got = state.detections_pred
    offline = tracker.process(got.drop(columns=["track_id",
                                                "track_bbox_ltwh",
                                                "track_bbox_conf"]),
                              state.image_pred).sort_index()
    tracked = got[got["track_id"].notna()].sort_index()
    _assert_tracks_equal(tracked, offline, "online vs process")
    return got, offline


def test_online_engine_re_emission_updates_its_row(tmp_path):
    """Two squares, the lower one missing from frame 10: StrongSORT coasts
    its track there and re-emits the lower square's row of frame 9. The
    port's online engine updates that row, as process() does. JAX's online
    engine appends the re-emission as a second row of that id without an
    image id (a reference fault, ROADMAP section 3); its other rows equal
    the port's."""
    from tracklab_torch.wrappers.dataset.external_video import ExternalVideo
    from tracklab_tpu.wrappers.dataset.external_video import \
        ExternalVideo as JExternalVideo

    _write_video(tmp_path / "clip.mp4", second=10)
    state, modules = _online("tracklab_torch", ExternalVideo(str(tmp_path)))
    jstate, _ = _online("tracklab_tpu", JExternalVideo(str(tmp_path)))
    got, offline = _assert_tracks_equal_process(state, modules[-1])
    assert len(got) == 39 and got.index.is_unique
    assert got["track_id"].nunique() == 2
    # the lower square's row of frame 9 holds the re-emission of frame 10:
    # the coasting track's box, not the detection's
    frame9 = got[got["image_id"] == "0_9"]
    row = frame9.index[np.argmax(np.stack(frame9["bbox_ltwh"])[:, 1])]
    box = got.at[row, "track_bbox_ltwh"]
    assert np.abs(box - got.at[row, "bbox_ltwh"]).max() > 1.0
    np.testing.assert_allclose(box, offline.at[row, "track_bbox_ltwh"],
                               rtol=0, atol=2.5e-4)
    # JAX: the same re-emission appended as a row without an image id
    want = jstate.detections_pred
    late = want.index.duplicated(keep="first")
    assert list(want.index[late]) == [row]
    assert want.loc[late, "image_id"].isna().all()
    np.testing.assert_allclose(want.loc[late, "track_bbox_ltwh"].iloc[0],
                               box, rtol=0, atol=2.5e-4)
    others = got.index != row
    _assert_tracks_equal(got[others], want[~late][others],
                         "online vs JAX, the re-emitted row aside")


def test_offline_engine_reads_the_file_as_the_online_engine(tmp_path):
    """``vid://`` frames through VideoReader (the offline engine's loader
    threads, out of order) are the frames the online engine decodes in
    order: the same detections and tracks."""
    from tracklab_torch.datastruct.tracker_state import TrackerState
    from tracklab_torch.engine import OfflineTrackingEngine
    from tracklab_torch.pipeline.module import Pipeline
    from tracklab_torch.utils.cv2 import VideoReader
    from tracklab_torch.wrappers.dataset.external_video import ExternalVideo

    _write_video(tmp_path / "clip.mp4", n_frames=40)
    ds = ExternalVideo(str(tmp_path / "clip.mp4"))
    online, _ = _online("tracklab_torch", ds)
    modules = _modules("tracklab_torch")
    state = TrackerState(ds.sets["val"], Pipeline(modules))
    OfflineTrackingEngine(tracker_state=state, modules=modules,
                          num_workers=4, device="cpu").track_dataset()
    got, want = state.detections_pred, online.detections_pred
    np.testing.assert_array_equal(np.stack(got["bbox_ltwh"].to_numpy()),
                                  np.stack(want["bbox_ltwh"].to_numpy()))
    np.testing.assert_array_equal(got["track_id"].to_numpy(float),
                                  want["track_id"].to_numpy(float))
    reader = VideoReader(str(tmp_path / "clip.mp4"))
    first = reader[7]
    np.testing.assert_array_equal(reader[3], reader[3])
    np.testing.assert_array_equal(reader[7], first)


# ------------------------------------------------------------ host modules
def _frames_on_disk(tmp_path, n=6):
    import cv2
    rows, dets = [], []
    (tmp_path / "frames").mkdir()
    for f in range(n):
        p = tmp_path / "frames" / f"{f:06d}.png"
        img = np.full((120, 160, 3), 30, np.uint8)
        img[:, :8 * f] = 90
        cv2.imwrite(str(p), img)
        rows.append(dict(id=f, video_id=0, frame=f + 1, file_path=str(p)))
        for k in range(2):
            dets.append(dict(id=2 * f + k, image_id=f, video_id=0,
                             track_id=float(k + 1), bbox_conf=0.9,
                             track_bbox_conf=0.8,
                             bbox_ltwh=np.array([10 + 5 * f + 60 * k, 20,
                                                 30, 40], np.float32)))
    return (pd.DataFrame(rows).set_index("id"),
            pd.DataFrame(dets).set_index("id"))


def _render(pkg, out, image_pred, detections, names, **kw):
    import importlib
    import types
    vis = importlib.import_module(f"{pkg}.visualization")
    engine = vis.VisualizationEngine(
        visualizers=[getattr(vis, n)() for n in names], save_videos=True,
        save_images=True, save_folder=str(out), fps=10, **kw)
    gt = detections.iloc[::2][["image_id", "video_id", "bbox_ltwh"]]
    fake = types.SimpleNamespace(
        tracker_state=types.SimpleNamespace(detections_gt=gt))
    engine.on_video_loop_end(fake, pd.Series({"name": "demo"}), 0,
                             detections, image_pred)
    import cv2
    assert (out / "demo.mp4").exists()
    return [cv2.imread(str(p)) for p in sorted((out / "demo")
                                                .glob("*.jpg"))]


VISUALIZERS = ["DefaultDetectionVisualizer", "TrackingLineVisualizer",
               "FrameCounterVisualizer", "EllipseDetectionVisualizer",
               "DebugDetectionVisualizer", "DetectionStatsVisualizer"]


def test_visualization_renders_jax_pixels(tmp_path):
    image_pred, detections = _frames_on_disk(tmp_path)
    got = _render("tracklab_torch", tmp_path / "torch", image_pred,
                  detections, VISUALIZERS)
    want = _render("tracklab_tpu", tmp_path / "jax", image_pred, detections,
                   VISUALIZERS)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[0] != 30).any()


def test_visualization_process_backend_equals_threads(tmp_path):
    """Rendering in spawned processes gives the threads' frames."""
    image_pred, detections = _frames_on_disk(tmp_path)
    names = ["DefaultDetectionVisualizer", "FrameCounterVisualizer"]
    got = _render("tracklab_torch", tmp_path / "proc", image_pred,
                  detections, names, num_workers=2,
                  parallel_backend="process")
    want = _render("tracklab_torch", tmp_path / "thread", image_pred,
                   detections, names, num_workers=2)
    assert len(got) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_ignored_regions_match_jax():
    from tracklab_torch.callbacks import IgnoredRegions
    from tracklab_tpu.callbacks import IgnoredRegions as JIgnoredRegions

    rng = np.random.default_rng(0)
    boxes = np.concatenate([rng.uniform(0, 280, (40, 2)),
                            rng.uniform(0, 60, (40, 2))], 1)
    boxes[0] = [0, 0, 0, 5]      # empty box
    meta = pd.Series(dict(im_width=320, im_height=240,
                          ignore_regions_x=[[0, 100, 100, 0],
                                            [200, 320, 260]],
                          ignore_regions_y=[[0, 0, 120, 120],
                                            [240, 240, 100]]), name=0)
    got = pd.DataFrame({"bbox_ltwh": list(boxes), "video_id": 0})
    want = got.copy()
    IgnoredRegions(0.5).on_video_loop_end(None, meta, 0, got, None)
    JIgnoredRegions(0.5).on_video_loop_end(None, meta, 0, want, None)
    np.testing.assert_array_equal(got["in_ignored_region"].to_numpy(),
                                  want["in_ignored_region"].to_numpy())
    assert 0 < got["in_ignored_region"].sum() < len(got)


def test_majority_vote_matches_jax():
    from tracklab_torch.wrappers.tracklet_agg import MajorityVoteTracklet
    from tracklab_tpu.wrappers.tracklet_agg import \
        MajorityVoteTracklet as JMajorityVoteTracklet

    rng = np.random.default_rng(1)
    n = 60
    dets = pd.DataFrame({
        "track_id": rng.choice([1.0, 2.0, 3.0, np.nan], n),
        "team_detection": rng.choice(["left", "right", None], n),
        "team_confidence": rng.uniform(0, 1, n),
        "role_detection": rng.choice(["player", "goalkeeper", np.nan], n),
    }, index=rng.permutation(1000)[:n])
    kw = dict(attributes=["team", "role"])
    got = MajorityVoteTracklet(**kw).process(dets, None)
    want = JMajorityVoteTracklet(**kw).process(dets, None)
    pd.testing.assert_frame_equal(got, want)
    assert got["team"].notna().any()


def test_torch_profiler_writes_a_trace(tmp_path):
    import json
    parts, _ = TM.main(QUICK[2:] + [
        "dataset.n_videos=1", "dataset.n_frames=8",
        "+modules.track.n_frame_bucket=8", "device=cpu",
        "+callbacks.profiler={_target_: tracklab_torch.callbacks."
        f"TorchProfiler, enabled: true, trace_dir: {tmp_path}}}"])
    prof = next(c for c in parts["callbacks"]
                if type(c).__name__ == "TorchProfiler")
    trace = json.loads(prof.trace_path.read_text())
    assert any("ocsort" in str(e.get("name", "")).lower()
               or e.get("cat") == "cpu_op" for e in trace["traceEvents"])


def test_load_from_overrides_builds_without_running():
    from tracklab_torch.utils.notebook import load_from_overrides
    te = load_from_overrides(QUICK + ["device=cpu", "dataset.n_videos=1"])
    assert te.tracker_state.detections_pred is None
    te.engine.track_dataset()
    assert te.tracker_state.detections_pred["track_id"].notna().all()
    assert te.cfg["device"] == "cpu"
