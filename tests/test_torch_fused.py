"""The port's main path, uint8 frames -> YOLOX -> NMS -> OC-SORT, vs the
JAX package's fused program on the CPU (tiny YOLOX, 128x128, f32)."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracklab_tpu.engine import fused as JF
from tracklab_tpu.models.yolox import YOLOX as JYOLOX
from tracklab_tpu.trackers import ocsort as JO
from tracklab_torch.engine import fused as TF
from tracklab_torch.models.convert import yolox_from_flax
from tracklab_torch.models.yolox import YOLOX
from tracklab_torch.trackers import ocsort as TO

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

F, CHUNK, D, SIZE = 8, 4, 16, 128
CONF, DET_THRESH = 0.25, 0.3


def _static_frames(n, seed):
    """Quasi-static video (tests/test_fused_pipeline.py:_static_frames)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(8, 247, (1, SIZE, SIZE, 3))
    jitter = rng.integers(-4, 5, (n, SIZE, SIZE, 3))
    return np.clip(base + jitter, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def models():
    jm = JYOLOX(num_classes=1, variant="tiny")
    # jitted init: the eager values, one compile instead of one per op
    v = jax.jit(partial(jm.init, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    tm = YOLOX(num_classes=1, variant="tiny", device="cpu")
    tm.load_state_dict(yolox_from_flax(jax.tree_util.tree_map(np.asarray, v)),
                       strict=True)
    return jm, v, tm


def _cfgs():
    kw = dict(max_tracks=32, max_dets=D, min_hits=1, det_thresh=DET_THRESH)
    return JO.OCSortConfig(**kw), TO.OCSortConfig(**kw)


def _run_jax(jm, v, frames):
    jcfg, _ = _cfgs()
    detect = JF.make_yolox_detect_fn(jm, v, conf_threshold=CONF, max_dets=D)
    return jax.jit(lambda f: JF.fused_detect_track(
        detect, partial(JO.ocsort_step, jcfg), JO.ocsort_init(jcfg), f,
        CHUNK))(jnp.asarray(frames))


def _run_torch(tm, frames):
    _, tcfg = _cfgs()
    detect = TF.make_yolox_detect_fn(tm, conf_threshold=CONF, max_dets=D)
    return TF.fused_detect_track(
        detect, partial(TO.ocsort_step, tcfg),
        TO.ocsort_init(tcfg, device="cpu"), torch.from_numpy(frames), CHUNK)


def test_fused_detect_track_matches_jax(models):
    jm, v, tm = models
    frames = _static_frames(F, seed=0)
    _, jd, jo = _run_jax(jm, v, frames)
    _, td, to = _run_torch(tm, frames)

    valid = np.asarray(jd.valid)
    assert valid.sum(axis=1).min() > 0, "random net found no detections"
    kept = np.asarray(jd.conf)[valid]
    # no kept score sits where a last-bit difference could flip a decision
    assert np.abs(kept - CONF).min() > 1e-4
    assert np.abs(kept - DET_THRESH).min() > 1e-4
    np.testing.assert_array_equal(td.valid.numpy(), valid)
    np.testing.assert_allclose(td.ltrb.numpy()[valid],
                               np.asarray(jd.ltrb)[valid], atol=1e-4)
    np.testing.assert_array_equal(td.ref.numpy(), np.asarray(jd.ref))

    ov = np.asarray(jo.valid)
    assert ov.any(), "tracker emitted nothing"
    np.testing.assert_array_equal(to.valid.numpy(), ov)
    np.testing.assert_array_equal(to.track_id.numpy()[ov],
                                  np.asarray(jo.track_id)[ov])
    np.testing.assert_allclose(to.ltrb.numpy()[ov], np.asarray(jo.ltrb)[ov],
                               rtol=1e-5, atol=1e-4)


def test_fused_concat_equals_per_video_runs(models):
    _, _, tm = models
    videos = np.stack([_static_frames(CHUNK, seed=s) for s in (1, 2)])
    _, tcfg = _cfgs()
    detect = TF.make_yolox_detect_fn(tm, conf_threshold=CONF, max_dets=D)
    step = partial(TO.ocsort_step, tcfg)
    _, cd, co = TF.fused_detect_track_concat(
        detect, step, TO.ocsort_init(tcfg, device="cpu"),
        torch.from_numpy(videos), CHUNK)
    for i in range(2):
        _, d, o = TF.fused_detect_track(
            detect, step, TO.ocsort_init(tcfg, device="cpu"),
            torch.from_numpy(videos[i]), CHUNK)
        assert o.valid.any()
        for name in ("valid", "track_id", "ltrb"):
            np.testing.assert_array_equal(getattr(co, name)[i].numpy(),
                                          getattr(o, name).numpy(), name)
        np.testing.assert_array_equal(cd.valid[i].numpy(), d.valid.numpy())
        # refs are stream-global in the concatenated run
        np.testing.assert_array_equal(cd.ref[i].numpy(),
                                      d.ref.numpy() + i * CHUNK * D)


def test_meta_unletterbox_matches_jax(models):
    jm, v, tm = models
    frames = _static_frames(CHUNK, seed=3)
    rng = np.random.default_rng(1)
    meta = dict(scale=rng.uniform(0.4, 0.9, CHUNK).astype(np.float32),
                pad=rng.uniform(0, 20, (CHUNK, 2)).astype(np.float32),
                shape=np.tile(np.float32([150.0, 110.0]), (CHUNK, 1)))
    jdet = JF.make_yolox_detect_fn(jm, v, conf_threshold=CONF, max_dets=D)
    want = jax.jit(jdet)(jnp.asarray(frames),
                         {k: jnp.asarray(x) for k, x in meta.items()})
    tdet = TF.make_yolox_detect_fn(tm, conf_threshold=CONF, max_dets=D)
    got = tdet(torch.from_numpy(frames),
               {k: torch.from_numpy(x) for k, x in meta.items()})
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    m = np.asarray(want.valid)
    np.testing.assert_allclose(got.ltrb.numpy()[m], np.asarray(want.ltrb)[m],
                               atol=1e-4)


def test_frame_valid_and_meta_pass_through(models):
    """Padded tail frames give no detections and no tracks; per-frame meta
    is sliced per chunk exactly as the detector sees it."""
    _, _, tm = models
    frames = torch.from_numpy(_static_frames(2 * CHUNK, seed=4))
    rng = np.random.default_rng(2)
    meta = dict(scale=torch.full((2 * CHUNK,), 0.8),
                pad=torch.from_numpy(rng.uniform(0, 9, (2 * CHUNK, 2))
                                     .astype(np.float32)),
                shape=torch.tensor([[150.0, 110.0]]).repeat(2 * CHUNK, 1))
    real = CHUNK + 1
    fv = torch.arange(2 * CHUNK) < real
    _, tcfg = _cfgs()
    detect = TF.make_yolox_detect_fn(tm, conf_threshold=CONF, max_dets=D)
    _, d, o = TF.fused_detect_track(
        detect, partial(TO.ocsort_step, tcfg),
        TO.ocsort_init(tcfg, device="cpu"), frames, CHUNK, meta=meta,
        frame_valid=fv)
    assert d.valid[:real].any() and o.valid[:real].any()
    assert not d.valid[real:].any() and not o.valid[real:].any()
    want = detect(frames[CHUNK:], {k: v[CHUNK:] for k, v in meta.items()})
    np.testing.assert_array_equal(d.ltrb[CHUNK:].numpy(), want.ltrb.numpy())
    np.testing.assert_array_equal(d.valid[CHUNK:real].numpy(),
                                  want.valid[:1].numpy())
