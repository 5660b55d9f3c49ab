"""The port's KPR wrappers and part-based fused paths against the JAX
package's on the CPU.

``KPReId`` (host crops, host prompt maps) and ``KPReIdBatched`` (device
crops and prompts), each with and without keypoints, on a tiny KPR (depth
2, embed 32, patch 8, crop 32 x 16) against JAX's modules: the crops and
prompt maps (the ``negative_kps`` channel included) equal, embeddings
within rtol/atol 1e-4, visibility equal. Then tests/test_fused_engine.py's
PARTS_ARGS (YOLOX-nano -> promptless KPR -> BPBReID) and GSR_ARGS (YOLOX-nano
-> TopDownPose-nano -> prompted KPR -> BPBReID with OKS motion) through
both command lines: the port's fused (``run_fused_parts_video``,
``run_fused_gsr_video``) and staged runs against JAX's staged run, within
JAX's own fused-vs-staged bounds. ``convert_kpr_torch`` on a reference-style
state dict.

The JAX YOLOX weights are its wrapper's PRNGKey(0) init (the score
thresholds of test_fused_engine.py are set for them); TopDownPose's and
KPR's are seeded numpy draws on the flax trees' shapes (no init program is
compiled; KPR's prompt conv drawn non-zero, so the prompts move the
embeddings). The port reads them through ``*_from_flax`` and
``checkpoint_path``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import test_fused_engine as TFE
from test_torch_yolox import jax_yolox_prng0
from tracklab_tpu import main as JM
from tracklab_tpu.config import compose as jcompose
from tracklab_tpu.models.kpr import KPR as JKPR
from tracklab_tpu.models.pose import TopDownPose as JTopDownPose
from tracklab_tpu.wrappers.reid import kpr_api as JKA
from tracklab_torch import main as TM
from tracklab_torch.models.convert import (convert_kpr_torch, kpr_from_flax,
                                           topdownpose_from_flax,
                                           yolox_from_flax)
from tracklab_torch.models.kpr import KPR
from tracklab_torch.wrappers.reid import KPReId, KPReIdBatched

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

CROP = (32, 16)
TINY = dict(num_parts=3, dim_reduce_output=16, embed_dim=32, depth=2,
            num_heads=2, patch_size=8, stride=8)
SIZE = 128


def _kpr_variables(seed=11):
    """Seeded tiny-KPR variables in the flax tree's shapes: kernels
    N(0, 1 / fan_in) (the prompt conv's too), class token and positional
    embedding N(0, 0.3), norm scales and BN variances in [0.5, 1.5],
    biases and BN means N(0, 0.05)."""
    model = JKPR(n_prompt_ch=7, img_size=CROP, **TINY)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + CROP + (3,)),
        jnp.zeros((1,) + CROP + (7,)), train=False))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            return (rng.normal(0, 1, a.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if name in ("cls_token", "pos_embed"):
            return rng.normal(0, 0.3, a.shape).astype(np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return rng.normal(0, 0.05, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _lecun(jmodel, shape, seed):
    """Seeded flax variables of ``jmodel``: lecun-normal kernels, identity
    BN, zero biases (the port's seeded pose draw)."""
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


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX's PRNGKey(0) YOLOX-nano init, the TopDownPose-nano and tiny-KPR
    draws, each also as a port checkpoint."""
    yv = jax_yolox_prng0(tmp_path_factory, "nano")
    pv = _lecun(JTopDownPose(num_keypoints=17, variant="nano"),
                (1, 64, 48, 3), seed=2)
    kv = _kpr_variables()
    tmp = tmp_path_factory.mktemp("kpr")
    torch.save(yolox_from_flax(jax.tree_util.tree_map(np.asarray, yv)),
               tmp / "yolox.pt")
    torch.save(topdownpose_from_flax(pv), tmp / "topdown.pt")
    torch.save(kpr_from_flax(kv), tmp / "kpr.pt")
    return {"yolox": yv, "pose": pv, "kpr": kv, "detect": tmp / "yolox.pt",
            "pose_path": tmp / "topdown.pt", "reid": tmp / "kpr.pt"}


# ------------------------------------------------------------ the wrappers
def _frame_rows(seed=3, n=5):
    """A random 128 x 128 frame and ``n`` detection rows on it: boxes (one
    past the border), 17 keypoints with confidences around ``vis_thresh``
    (0.3) and some at 0, and other people's keypoints on two rows."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (SIZE, SIZE, 3), dtype=np.uint8)
    rows = []
    for i in range(n):
        lt = rng.uniform(-6, 90, 2)
        wh = rng.uniform(14, 40, 2) * [0.6, 1.4]
        kp = np.concatenate([lt + rng.uniform(0, 1, (17, 2)) * wh,
                             rng.uniform(-0.1, 0.8, (17, 1))], 1)
        kp[rng.uniform(size=17) < 0.2, 2] = 0.0
        row = dict(bbox_ltwh=np.array([*lt, *wh], np.float32),
                   keypoints_xyc=kp.astype(np.float32))
        if i % 2:
            neg = np.concatenate([lt + rng.uniform(-0.2, 1.2, (6, 2)) * wh,
                                  np.ones((6, 1))], 1)
            row["negative_kps"] = neg.astype(np.float32)
        rows.append(row)
    return img, pd.DataFrame(rows, index=[3, 8, 13, 21, 34][:n])


@pytest.mark.parametrize("use_keypoints", [False, True])
def test_kpreid_matches_jax(weights, use_keypoints):
    """The detection-level ``KPReId``: each row's crop and its 7 prompt
    channels (cck6 groups of the keypoints of confidence >= 0.3, the
    negative keypoints last) equal JAX's; the embeddings of the batch
    within rtol/atol 1e-4; the binary visibility equal."""
    img, rows = _frame_rows()
    kw = dict(crop_size=CROP, batch_size=8, use_keypoints=use_keypoints,
              **TINY)
    jmod = JKA.KPReId(**kw)
    jmod.variables = weights["kpr"]
    tmod = KPReId(checkpoint_path=str(weights["reid"]), device="cpu", **kw)
    assert tmod.input_columns == jmod.input_columns
    assert tmod.supports_fused_parts == (not use_keypoints)
    assert tmod.supports_fused_prompted_parts == use_keypoints
    samples = []
    for _, det in rows.iterrows():
        t, j = tmod.preprocess(img, det, None), jmod.preprocess(img, det,
                                                                 None)
        np.testing.assert_array_equal(t["crop"], j["crop"])
        np.testing.assert_array_equal(t["prompts"], j["prompts"])
        samples.append(t)
    prompts = np.stack([s["prompts"] for s in samples])
    assert prompts.shape[1:] == CROP + (7,)
    if use_keypoints:
        assert prompts[..., :6].max() > 0.5
        assert prompts[1, ..., 6].max() > 0.5 and prompts[0, ..., 6].max() == 0
    else:
        assert not prompts.any()
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    got = tmod.process(batch, rows, None)
    want = jmod.process(batch, rows, None)
    pd.testing.assert_index_equal(got.index, want.index)
    np.testing.assert_allclose(np.stack(got["embeddings"].to_numpy()),
                               np.stack(want["embeddings"].to_numpy()),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        np.stack(got["visibility_scores"].to_numpy()),
        np.stack(want["visibility_scores"].to_numpy()))
    assert np.stack(got["embeddings"].to_numpy()).shape[1:] == (4, 16)


@pytest.mark.parametrize("use_keypoints", [False, True])
def test_kpreid_batched_matches_jax(weights, use_keypoints):
    """``KPReIdBatched`` on two frames (the second 96 x 160: the work image
    a resize): the work images, padded boxes, rows and keypoints in work
    coordinates equal JAX's; the embeddings within rtol/atol 1e-4; the
    visibility equal."""
    import cv2
    img, rows = _frame_rows()
    img2 = cv2.resize(img, (160, 96))
    rows2 = rows.iloc[:3].copy()
    rows2.index = [50, 51, 52]
    kw = dict(crop_size=CROP, batch_size=2, use_keypoints=use_keypoints,
              work_size=(SIZE, SIZE), max_dets=8, **TINY)
    jmod = JKA.KPReIdBatched(**kw)
    jmod.variables = weights["kpr"]
    tmod = KPReIdBatched(checkpoint_path=str(weights["reid"]), device="cpu",
                         **kw)
    assert tmod.level == "image" and tmod.input_columns == jmod.input_columns
    samples = []
    for im, r in ((img, rows), (img2, rows2)):
        t, j = tmod.preprocess(im, r, None), jmod.preprocess(im, r, None)
        assert set(t) == set(j)
        for k in t:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        samples.append(t)
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    both = pd.concat([rows, rows2])
    got = tmod.process(batch, both, None)
    want = jmod.process(batch, both, None)
    pd.testing.assert_index_equal(got.index, want.index)
    np.testing.assert_allclose(np.stack(got["embeddings"].to_numpy()),
                               np.stack(want["embeddings"].to_numpy()),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        np.stack(got["visibility_scores"].to_numpy()),
        np.stack(want["visibility_scores"].to_numpy()))
    # a short batch is padded to batch_size: one frame gives its own rows
    one = tmod.process({k: v[:1] for k, v in batch.items()}, rows, None)
    np.testing.assert_array_equal(np.stack(one["embeddings"].to_numpy()),
                                  np.stack(got["embeddings"].to_numpy())[:5])


def test_convert_kpr_torch_loads_reference_names(weights):
    """``convert_kpr_torch`` on a reference-style KPR state dict (a
    ``module.`` prefix, the fork's ``base.`` / ``*_identity_classifier.bn``
    / ``*_after_pooling_dim_reduce`` names, the identity classifier heads
    and ``num_batches_tracked``) gives the model of the port's own state
    dict; a missing tensor raises."""
    own = kpr_from_flax(weights["kpr"])
    names = dict(
        (("backbone.", "base."), ("bn_foreground.",
                                  "foreground_identity_classifier.bn."),
         ("dim_reduce_parts.", "parts_after_pooling_dim_reduce.")))
    ref = {}
    for k, v in own.items():
        for new, old in names.items():
            if k.startswith(new):
                k = old + k[len(new):]
                break
        ref["module." + k] = v.numpy()
    ref["module.parts_identity_classifier.classifier.weight"] = np.zeros(
        (10, 16), np.float32)
    ref["module.bn_global.num_batches_tracked"] = np.zeros((), np.int64)
    model = convert_kpr_torch(ref, KPR(n_prompt_ch=7, img_size=CROP,
                                       device="cpu", **TINY))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, own[k], rtol=0, atol=0)
    del ref["module.base.cls_token"]
    with pytest.raises(ValueError, match="missing"):
        convert_kpr_torch(ref, KPR(n_prompt_ch=7, img_size=CROP,
                                   device="cpu", **TINY))


def test_kpreid_train_names_its_roadmap_item():
    """``train`` is ported (tests/test_torch_reid_train.py holds it against
    JAX): on a set without ground-truth crops it trains nothing and returns
    no metrics, as JAX's ``train_kpr`` does."""
    empty = types.SimpleNamespace(sets={"train": types.SimpleNamespace(
        detections_gt=pd.DataFrame(), image_metadatas=pd.DataFrame())})
    for cls in (KPReId, KPReIdBatched):
        mod = cls(device="cpu")
        assert mod.train(empty) == {}
        assert mod._model is None and mod._trained is None


# --------------------------------------------------- the command lines
PKG = "tracklab_tpu"
PARTS = TFE.PARTS_ARGS
GSR = TFE.GSR_ARGS


def _args(args, pkg):
    return [a.replace(PKG, pkg) for a in args]


def _jax_run(args, weights):
    """JAX's staged run of ``args`` in this process with the test's weights
    set on its detector, pose and KPR modules."""
    from tracklab_tpu.wrappers.pose_estimator import TopDownPoseBatched
    cfg = jcompose(JM.CONFIG_DIR, "config", args + ["engine.fused=false"])
    JM.init_environment(cfg)
    parts = JM.build(cfg)
    for m in parts["modules"]:
        if hasattr(m, "_make_model"):
            m._variables = weights["yolox"]
        elif isinstance(m, TopDownPoseBatched):
            m.variables = weights["pose"]
        elif isinstance(m, JKA.KPReId):
            m.variables = weights["kpr"]
    parts["engine"].track_dataset()
    return parts["tracker_state"].detections_pred


def _torch_run(args, weights, fused):
    ckpts = [f"+modules.detect.checkpoint_path={weights['detect']}",
             f"+modules.reid.checkpoint_path={weights['reid']}"]
    if any(a.startswith("+modules.pose.") for a in args):
        ckpts.append(f"+modules.pose.checkpoint_path={weights['pose_path']}")
    parts, _ = TM.main(_args(args, "tracklab_torch") + ckpts + [
        "device=cpu", f"engine.fused={str(fused).lower()}"])
    return parts["tracker_state"].detections_pred


@pytest.fixture(scope="module", params=["parts", "gsr"])
def cli_runs(request, weights):
    """JAX's staged run of PARTS_ARGS or GSR_ARGS and the port's fused and
    staged runs."""
    args = PARTS if request.param == "parts" else GSR
    return request.param, _jax_run(args, weights), {
        mode: _torch_run(args, weights, mode == "fused")
        for mode in ("fused", "staged")}


@pytest.mark.parametrize("mode", ["fused", "staged"])
def test_parts_cli_matches_jax(cli_runs, mode):
    """Rows and ids equal, boxes within atol 1e-3 (rtol 1e-4), keypoints
    and part embeddings within rtol/atol 1e-3 (the bounds of JAX's own
    fused-vs-staged test), visibility equal, track ids and (parts) the
    lifecycle columns equal."""
    name, want, runs = cli_runs
    got = runs[mode]
    assert len(want) >= 10 * 3, "too few detections to mean much"
    pd.testing.assert_index_equal(got.index, want.index)
    for col in ("image_id", "video_id", "category_id"):
        np.testing.assert_array_equal(got[col].to_numpy(float),
                                      want[col].to_numpy(float), err_msg=col)
    np.testing.assert_allclose(np.stack(got["bbox_ltwh"].to_numpy()),
                               np.stack(want["bbox_ltwh"].to_numpy()),
                               rtol=1e-4, atol=1e-3)
    if name == "gsr":
        np.testing.assert_allclose(
            np.stack(got["keypoints_xyc"].to_numpy()),
            np.stack(want["keypoints_xyc"].to_numpy()), rtol=1e-3, atol=1e-3)
    emb = np.stack(got["embeddings"].to_numpy())
    assert emb.shape[1:] == (4, 16)
    np.testing.assert_allclose(emb, np.stack(want["embeddings"].to_numpy()),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(
        np.stack(got["visibility_scores"].to_numpy()),
        np.stack(want["visibility_scores"].to_numpy()))
    wv, gv = want["track_id"].notna(), got["track_id"].notna()
    assert wv.sum() > 0, "the tracker emitted nothing"
    np.testing.assert_array_equal(gv.to_numpy(), wv.to_numpy())
    np.testing.assert_array_equal(got.loc[gv, "track_id"].to_numpy(float),
                                  want.loc[wv, "track_id"].to_numpy(float))
    for col in ("hits", "age", "time_since_update", "state"):
        np.testing.assert_array_equal(got.loc[gv, col].to_numpy(float),
                                      want.loc[wv, col].to_numpy(float),
                                      err_msg=col)
