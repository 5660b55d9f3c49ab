"""The port's ReID path, uint8 frames -> YOLOX -> NMS -> device crops ->
OSNet embeddings -> StrongSORT, vs the JAX package's
``fused_detect_reid_track`` on the CPU (YOLOX-nano at 128 x 128, OSNet
x0_25 with 32-d features on 128 x 64 crops, 16 detection slots, chunks of
4).

The port runs with ``embed_buckets`` None and (4, 8, 16) against one JAX
run at full width (the JAX package's own tests hold its bucketed and
full-width runs equal): detections and tracks equal id for id, the ReID
outputs within 1e-4 of their scale (the crops' sample positions are f32
here and f64 in JAX under x64). A tracker width above the model's (zero-padded
embeddings) gives the same tracks.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracklab_tpu.engine import fused as JF
from tracklab_tpu.models.osnet import OSNet as JOSNet
from tracklab_tpu.models.yolox import YOLOX as JYOLOX
from tracklab_tpu.trackers import strongsort as JS
from tracklab_torch.engine import fused as TF
from tracklab_torch.models.convert import osnet_from_flax, yolox_from_flax
from tracklab_torch.models.yolox import YOLOX
from tracklab_torch.trackers import strongsort as TS
from test_torch_yolox import jax_yolox_prng0

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

F, CHUNK, D, SIZE, E = 8, 4, 16, 128, 32
CROP = (128, 64)
OSNET = dict(variant="x0_25", feat_dim=E, n_parts=4)
CFG_KW = dict(max_tracks=16, max_dets=D, embed_dim=E, n_init=1,
              nn_budget=10, max_dist=0.3)


def _static_frames(n, seed):
    """Quasi-static video (tests/test_fused_pipeline.py:_static_frames)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(8, 247, (1, SIZE, SIZE, 3))
    jitter = rng.integers(-4, 5, (n, SIZE, SIZE, 3))
    return np.clip(base + jitter, 0, 255).astype(np.uint8)


def _osnet_variables(jo):
    """Seeded OSNet variables in the shapes of the flax tree (no init
    program is compiled): He-normal kernels, norm scales and variances in
    [0.5, 1.5], biases and means N(0, 0.05)."""
    shapes = jax.eval_shape(lambda: jo.init(
        jax.random.PRNGKey(2), jnp.zeros((1,) + CROP + (3,)), train=False))
    rng = np.random.default_rng(1)

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


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jy = JYOLOX(num_classes=1, variant="nano")
    yv = jax_yolox_prng0(tmp_path_factory, "nano")
    jo = JOSNet(**OSNET)
    ov = _osnet_variables(jo)
    frames = _static_frames(F, seed=12)
    ty = YOLOX(num_classes=1, variant="nano", device="cpu")
    ty.load_state_dict(yolox_from_flax(jax.tree_util.tree_map(np.asarray,
                                                              yv)),
                       strict=True)
    # the score threshold halfway between two adjacent scores (the port's
    # detector gives the JAX scores to ~1e-7), so no score sits on it
    probe = TF.make_yolox_detect_fn(ty, conf_threshold=0.0, max_dets=D)(
        torch.from_numpy(frames))
    scores = np.sort(probe.conf[probe.valid].numpy())[::-1]
    i = min(F * D // 3, len(scores) - 2)
    conf = float((scores[i] + scores[i + 1]) / 2)
    detect = JF.make_yolox_detect_fn(jy, yv, conf_threshold=conf,
                                     max_dets=D)
    embed = JF.make_osnet_embed_fn(jo, ov, crop_size=CROP)
    cfg = JS.StrongSortConfig(**CFG_KW)
    run = jax.jit(lambda f: JF.fused_detect_reid_track(
        detect, embed, partial(JS.strongsort_step, cfg),
        JS.strongsort_init(cfg), f, CHUNK, min_confidence=0.2, embed_dim=E,
        return_embeddings=True))
    ref = jax.tree_util.tree_map(np.asarray, run(jnp.asarray(frames)))
    to = osnet_from_flax(ov, n_parts=OSNET["n_parts"], device="cpu")
    return frames, conf, ty, to, ref


def _run(setup, buckets, embed_dim=E):
    frames, conf, ty, to, _ = setup
    cfg = TS.StrongSortConfig(**dict(CFG_KW, embed_dim=embed_dim))
    detect = TF.make_yolox_detect_fn(ty, conf_threshold=conf, max_dets=D)
    embed = TF.make_osnet_embed_fn(to, crop_size=CROP)
    return TF.fused_detect_reid_track(
        detect, embed, partial(TS.strongsort_step, cfg),
        TS.strongsort_init(cfg, device="cpu"), torch.from_numpy(frames),
        CHUNK, min_confidence=0.2, embed_dim=embed_dim,
        embed_buckets=buckets, return_embeddings=True)


def _same_tracks(to, jo):
    ov = jo.valid
    assert ov.any(), "tracker emitted nothing"
    np.testing.assert_array_equal(to.valid.numpy(), ov)
    np.testing.assert_array_equal(to.track_id.numpy()[ov], jo.track_id[ov])
    np.testing.assert_array_equal(to.ref.numpy()[ov], jo.ref[ov])
    np.testing.assert_allclose(to.ltrb.numpy()[ov], jo.ltrb[ov], rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("buckets", [None, (4, 8, D)])
def test_reid_path_matches_jax(setup, buckets):
    _, jd, jr, jo = setup[-1]
    _, td, tr, to = _run(setup, buckets)
    valid = jd.valid
    live = valid.sum(1).max()
    assert 0 < live < D, "need a non-trivial live prefix"
    np.testing.assert_array_equal(td.valid.numpy(), valid)
    np.testing.assert_array_equal(td.ref.numpy(), jd.ref)
    np.testing.assert_allclose(td.ltrb.numpy()[valid], jd.ltrb[valid],
                               atol=1e-4)
    assert set(tr) == set(jr) == {"embeddings", "part_features",
                                  "visibility"}
    for k in tr:
        assert tr[k].shape == jr[k].shape, k
        np.testing.assert_allclose(tr[k].numpy(), jr[k], rtol=0,
                                   atol=1e-4 * max(np.abs(jr[k]).max(), 1.0),
                                   err_msg=k)
    _same_tracks(to, jo)


def test_wider_tracker_pads_embeddings(setup):
    """embed_dim 40 > the model's 32: the embeddings are zero-padded, so
    cosine distances and tracks do not change."""
    jo = setup[-1][-1]
    _, _, _, to = _run(setup, None, embed_dim=40)
    _same_tracks(to, jo)


def test_bucketed_equals_full_width(setup):
    """The port's bucketed and full-width runs give identical detections,
    tracks and ReID outputs on the valid slots (the counterpart of
    tests/test_fused_pipeline.py:248, which holds the JAX package's two
    forms within 1e-5): full width is the form the card runs, with no host
    read of the live count."""
    _, fd, fr, fo = _run(setup, None)
    _, bd, br, bo = _run(setup, (4, 8, D))
    assert fd.valid.sum(1).max() < D, "need a non-trivial live prefix"
    for a, b in zip((*fd, *fo), (*bd, *bo)):
        assert torch.equal(a, b)
    v = fd.valid
    for k in fr:
        assert torch.equal(fr[k][v], br[k][v]), k
        assert not br[k][~v].any(), k
