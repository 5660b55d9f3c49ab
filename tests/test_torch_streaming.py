"""The port's tracker wrappers in streaming (``process_online``) and
multi-video (``process_video_batch``) modes, on the CPU, against the port's
own ``process`` and the JAX package's: OC-SORT, ByteTrack, StrongSORT,
BoT-SORT and Deep-OC-SORT on seeded streams with dropouts, per-identity
embeddings and camera warps (tests/test_streaming_equivalence.py's
streams), with overflow frames, empty frames, None embeddings, in-module
ECC and ``reset()``; three videos of unequal length stepped together."""
import numpy as np
import pandas as pd
import pytest
import torch

from tracklab_torch.wrappers.track import scan_tracker as PT
from tracklab_tpu.wrappers.track import scan_tracker as JT

# one intra-op thread per process: the suite runs in parallel workers
torch.set_num_threads(1)

E = 32          # embedding dim
N_FRAMES = 24
N_OBJ = 5


def _stream(seed=0, with_warps=False, n_frames=N_FRAMES, empty=()):
    """One video's detection rows and image rows: N_OBJ objects moving
    with noise, 15 % dropouts, an embedding per identity with noise, a
    random camera shift per frame with ``with_warps``; the frames in
    ``empty`` have no detection."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform([50, 50], [800, 500], (N_OBJ, 2))
    vel = rng.uniform(-5, 5, (N_OBJ, 2))
    size = rng.uniform(30, 90, (N_OBJ, 2))
    ident = rng.normal(0, 1, (N_OBJ, E)).astype(np.float32)
    ident /= np.linalg.norm(ident, axis=1, keepdims=True)
    rows = []
    for f in range(n_frames):
        pos = pos + vel
        for o in range(N_OBJ):
            if rng.uniform() < 0.15 or f in empty:
                continue
            c = pos[o] + rng.normal(0, 1.5, 2)
            emb = ident[o] + rng.normal(0, 0.05, E).astype(np.float32)
            rows.append(dict(
                image_id=f, video_id=0,
                bbox_ltwh=np.array([c[0], c[1], size[o, 0], size[o, 1]],
                                   np.float32),
                bbox_conf=float(rng.uniform(0.55, 0.99)), category_id=1,
                embeddings=emb / np.linalg.norm(emb)))
    dets = pd.DataFrame(rows, index=1000 * seed + np.arange(len(rows)))
    metas = []
    for f in range(n_frames):
        m = dict(file_path=f"{f}.jpg", video_id=0, frame=f)
        if with_warps:
            w = np.eye(2, 3, dtype=np.float32)
            w[:, 2] = rng.normal(0, 2.0, 2)
            m["gmc_warp"] = w
        metas.append(m)
    return dets, pd.DataFrame(metas, index=range(n_frames))


def _streaming(tracker, dets, metas):
    """``process_online`` frame by frame; a later emission of a row
    overrides an earlier one, as the engine's merge does."""
    tracker.reset()
    outs = [tracker.process_online(dets[dets["image_id"] == f], metas.loc[f])
            for f in metas.index]
    cat = pd.concat([o for o in outs if len(o)])
    return cat[~cat.index.duplicated(keep="last")]


def _assert_equal(got, want, tag):
    got, want = got.sort_index(), want.sort_index()
    assert list(got.index) == list(want.index), f"{tag}: rows differ"
    assert len(want) > 0, f"{tag}: nothing tracked"
    np.testing.assert_array_equal(got["track_id"].to_numpy(float),
                                  want["track_id"].to_numpy(float),
                                  err_msg=f"{tag}: track ids")
    np.testing.assert_allclose(
        np.stack(got["track_bbox_ltwh"].to_numpy()),
        np.stack(want["track_bbox_ltwh"].to_numpy()), rtol=1e-5,
        atol=1e-4, err_msg=f"{tag}: boxes")
    np.testing.assert_allclose(got["track_bbox_conf"].to_numpy(float),
                               want["track_bbox_conf"].to_numpy(float),
                               rtol=1e-6, atol=1e-6, err_msg=f"{tag}: conf")


SMALL = dict(max_tracks=16, max_dets=8)
EMB = dict(SMALL, embed_dim=E)
# name, wrapper class, its arguments, camera warps in the stream
TRACKERS = [("OCSORT", SMALL, False), ("ByteTrack", SMALL, False),
            ("StrongSORT", EMB, False), ("BotSORT", EMB, True),
            ("DeepOCSORT", EMB, True)]
IDS = [t[0] for t in TRACKERS]


_JAX = {}


def _pair(name, **kw):
    """A factory of the port's wrapper (on the CPU), and JAX's wrapper,
    one per configuration: its jitted scan compiles once per wrapper."""
    key = (name, tuple(sorted(kw.items())))
    if key not in _JAX:
        _JAX[key] = getattr(JT, name)(**kw)
    return lambda: getattr(PT, name)(device="cpu", **kw), _JAX[key]


@pytest.mark.parametrize("name,kw,warps", TRACKERS, ids=IDS)
def test_streaming_equals_process_and_jax(name, kw, warps):
    dets, metas = _stream(seed=len(name), with_warps=warps,
                          empty=(6, 7, 15))
    port, jax_ = _pair(name, **kw)
    offline = port().process(dets.copy(), metas)
    _assert_equal(offline, jax_.process(dets.copy(), metas),
                  f"{name}: process vs JAX")
    _assert_equal(_streaming(port(), dets, metas), offline,
                  f"{name}: process_online vs process")


@pytest.mark.parametrize("name,kw", [("OCSORT", SMALL),
                                     ("StrongSORT", EMB)],
                         ids=["OCSORT", "StrongSORT"])
def test_streaming_overflow_equals_process_and_jax(name, kw):
    """13 objects in every frame against a capacity of 8: both modes keep
    the 8 most confident rows."""
    rng = np.random.default_rng(3)
    pos = rng.uniform([50, 50], [800, 500], (13, 2))
    vel = rng.uniform(-4, 4, (13, 2))
    ident = rng.normal(0, 1, (13, E)).astype(np.float32)
    rows = []
    for f in range(12):
        pos = pos + vel
        for o in range(13):
            rows.append(dict(
                image_id=f, video_id=0,
                bbox_ltwh=np.array([*(pos[o] + rng.normal(0, 1.0, 2)),
                                    60.0, 80.0], np.float32),
                bbox_conf=float(rng.uniform(0.55, 0.99)), category_id=1,
                embeddings=ident[o] + rng.normal(0, 0.05, E)))
    dets = pd.DataFrame(rows)
    metas = pd.DataFrame([dict(file_path=f"{f}.jpg", video_id=0, frame=f)
                          for f in range(12)])
    port, jax_ = _pair(name, **kw)
    offline = port().process(dets.copy(), metas)
    _assert_equal(offline, jax_.process(dets.copy(), metas),
                  f"{name}: overflow, process vs JAX")
    _assert_equal(_streaming(port(), dets, metas), offline,
                  f"{name}: overflow, process_online vs process")


def test_streaming_none_embeddings_equal_process_and_jax():
    """A None embedding zeroes that row only, in both modes."""
    dets, metas = _stream(seed=11)
    emb = dets["embeddings"].copy()
    emb.loc[dets.index[::4]] = None
    dets = dets.assign(embeddings=emb)
    port, jax_ = _pair("StrongSORT", **EMB)
    offline = port().process(dets.copy(), metas)
    _assert_equal(offline, jax_.process(dets.copy(), metas),
                  "None embeddings: process vs JAX")
    _assert_equal(_streaming(port(), dets, metas), offline,
                  "None embeddings: process_online vs process")


def test_streaming_state_persists_and_resets():
    """Two streams with reset() between them are equal; ids carry from
    the first frame to the last within one; reset() empties the state and
    the stream's lut."""
    dets, metas = _stream(seed=7)
    tracker = PT.OCSORT(device="cpu", **SMALL)
    a = _streaming(tracker, dets, metas)
    _assert_equal(_streaming(tracker, dets, metas), a, "reset")
    first = set(a.loc[a.index.isin(dets.index[dets.image_id == 0]),
                      "track_id"])
    last = set(a.loc[a.index.isin(dets.index[dets.image_id == N_FRAMES - 1]),
                     "track_id"])
    assert first & last, "no identity carried across the stream"
    assert tracker._online_state is not None and tracker._online_lut
    tracker.reset()
    assert tracker._online_state is None and not tracker._online_lut


def test_streaming_cmc_off_ignores_the_warp_column():
    dets, metas = _stream(seed=3, with_warps=True)
    plain = PT.DeepOCSORT(device="cpu", **EMB).process(
        dets, metas.drop(columns=["gmc_warp"]))
    _assert_equal(_streaming(PT.DeepOCSORT(device="cpu", cmc_off=True,
                                           **EMB), dets, metas), plain,
                  "cmc_off")


def test_streaming_in_module_ecc_equals_process(tmp_path):
    """StrongSORT(ecc=True) estimates each frame's warp against the
    previous streamed frame, as ``process`` does over the whole video."""
    import cv2
    rng = np.random.default_rng(7)
    big = cv2.GaussianBlur(rng.integers(0, 255, (120, 160 + 2 * N_FRAMES,
                                                 3)).astype(np.uint8),
                           (7, 7), 2)
    dets, metas = _stream(seed=5)
    paths = []
    for f in range(N_FRAMES):
        paths.append(str(tmp_path / f"{f:03d}.png"))
        cv2.imwrite(paths[-1], big[:, 2 * f:2 * f + 160])
    metas = metas.assign(file_path=paths)
    offline = PT.StrongSORT(device="cpu", ecc=True, **EMB).process(dets,
                                                                   metas)
    _assert_equal(_streaming(PT.StrongSORT(device="cpu", ecc=True, **EMB),
                             dets, metas), offline, "ECC")


def _videos(with_warps):
    """Three videos of 24, 17 and 40 frames (the last one past a 32-frame
    bucket), with distinct row ids."""
    items = []
    for v, n in enumerate((24, 17, 40)):
        dets, metas = _stream(seed=20 + v, with_warps=with_warps, n_frames=n,
                              empty=(3,) if v == 1 else ())
        items.append((dets.assign(image_id=dets["image_id"] + 1000 * v),
                      metas.set_axis(metas.index + 1000 * v)))
    return items


@pytest.mark.parametrize("name,kw,warps", TRACKERS, ids=IDS)
def test_video_batch_equals_process(name, kw, warps, monkeypatch):
    """The V videos step together, one ``*_scan_videos`` call for all of
    them and no per-video ``process``; each video's rows equal its own
    ``process``."""
    items = _videos(warps)
    kw = dict(kw, n_frame_bucket=16)
    want = [getattr(PT, name)(device="cpu", **kw).process(d, m)
            for d, m in items]
    mod = getattr(PT, name)(device="cpu", **kw)
    calls = []
    scan_videos = mod._scan_videos_fn()

    def counted(cfg, dets, *rest):
        calls.append(dets.ltrb.shape)
        return scan_videos(cfg, dets, *rest)

    monkeypatch.setattr(mod, "_scan_videos_fn", lambda: counted)
    monkeypatch.setattr(mod, "process", None)
    got = mod.process_video_batch(items)
    assert calls == [(3, 48, kw["max_dets"], 4)]
    for v, (g, w) in enumerate(zip(got, want)):
        _assert_equal(g, w, f"{name}: video {v}")


@pytest.mark.parametrize("name,kw,warps", [TRACKERS[0], TRACKERS[4]],
                         ids=["OCSORT", "DeepOCSORT"])
def test_video_batch_matches_jax(name, kw, warps):
    items = _videos(warps)
    port, jax_ = _pair(name, **dict(kw, n_frame_bucket=16))
    for v, (g, w) in enumerate(zip(port().process_video_batch(items),
                                   jax_.process_video_batch(items))):
        _assert_equal(g, w, f"{name}: video {v} vs JAX")
