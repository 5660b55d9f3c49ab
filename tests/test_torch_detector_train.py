"""Detector and pose training in the port against the JAX package on the
CPU: YOLOv8/YOLO11 (TAL + CIoU + DFL), RT-DETR (set matching on K2's plain
version, VFL + L1 + GIoU) in its lightweight and HF forms, RTMDet and the
top-down pose step.

- Each loss and its gradient with respect to the model's outputs, on seeded
  outputs and ground truth with padded slots, against ``jax.value_and_grad``
  of JAX's loss (jitted): loss within 1e-5 relative, gradient within 1e-4
  of its largest magnitude; TAL's assignment and the set matching equal
  (R > C, transposed, and R <= C; tied costs).
- One training step at the smallest sizes JAX's own tests train
  (tests/test_yolov8_train.py, tests/test_rtdetr_train.py,
  tests/test_models.py: YOLOv8n and RT-DETR-nano with 12 queries at 96 x 96,
  TopDownPose-nano on 64 x 32 crops; RT-DETR HF at
  tests/test_fused_pipeline.py's tiny configuration): the wrapper's
  ``detection_loss_fn`` and ``_preproc`` in the port's ``make_train_step``
  against JAX's jitted step from the same variables (seeded numpy draws on
  the flax trees' shapes): the loss, every gradient, the parameters after
  AdamW (Adam for pose) and the BN statistics.
- The wrappers' ``train`` (``train_detector``) on a four-image tree:
  YOLOv8n, YOLO11n, RT-DETR and RT-DETR HF train and then detect; RT-DETR
  raises before the first step where K2 could not take its matching;
  RTMDet's ``train`` raises in both packages (a reference fault).

JAX compiles one training step per family and each loss once.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_pose import _variables as pose_variables
from test_torch_rtdetr import TINY as HF_TINY
from test_torch_rtdetr import _variables as rtdetr_variables
from test_torch_train import _four_image_tree
from test_torch_yolov8 import _variables as yolo_variables
from tracklab_tpu.models import pose_train as JPT
from tracklab_tpu.models import rtdetr_hf as JH
from tracklab_tpu.models import rtdetr_train as JRT
from tracklab_tpu.models import yolov8_train as JV8
from tracklab_tpu.models.pose import TopDownPose as JTopDownPose
from tracklab_tpu.models.rtdetr import RTDETR as JRTDETR
from tracklab_tpu.models.rtmdet import RTMDet as JRTMDet
from tracklab_tpu.models.yolov8 import YOLOv8 as JYOLOv8
from tracklab_tpu.ops.assignment import matching_forced as jmatching
from tracklab_tpu.wrappers.bbox_detector import rtdetr_api as JRA
from tracklab_tpu.wrappers.bbox_detector.rtmdet_api import \
    RTMDetDetector as JRTMDetDetector
from tracklab_tpu.wrappers.bbox_detector.yolov8_api import \
    YOLOv8Detector as JYOLOv8Detector
from tracklab_torch.models import pose_train as TPT
from tracklab_torch.models import rtdetr_hf as TH
from tracklab_torch.models import rtdetr_train as TRT
from tracklab_torch.models import yolov8_train as TV8
from tracklab_torch.models.convert import (rtdetr_from_flax,
                                           rtdetr_hf_from_flax,
                                           topdownpose_from_flax,
                                           yolov8_from_flax)
from tracklab_torch.models.pose import TopDownPose
from tracklab_torch.models.rtdetr import RTDETR
from tracklab_torch.models.rtmdet import RTMDet
from tracklab_torch.models.train import create_train_state, make_train_step
from tracklab_torch.models.yolov8 import YOLOv8
from tracklab_torch.ops.assignment import matching_forced
from tracklab_torch.wrappers.bbox_detector import (RTDETRDetector,
                                                   RTMDetDetector,
                                                   YOLOv8Detector)

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

H = W = 96


def _gt(B=2, G=4, size=H):
    """tests/test_yolov8_train.py's boxes ([cx, cy, w, h, cls] in pixels at
    96 x 96, two in image 0 and one in image 1, the other slots padded),
    with one more box in image 1 overlapping the first."""
    gt = np.zeros((B, G, 5), np.float32)
    gt[0, 0] = [30, 30, 24, 24, 0]
    gt[0, 1] = [70, 60, 20, 30, 1]
    gt[1, 0] = [48, 48, 40, 40, 1]
    gt[1, 1] = [54, 44, 30, 36, 0]
    gt[..., :4] *= size / 96
    gv = np.zeros((B, G), bool)
    gv[0, :2] = True
    gv[1, :2] = True
    return gt, gv


def _close_grad(got, want, tol=1e-4):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * scale)


# ------------------------------------------------------------ the losses
def _v8_maps(seed, B=2, C=2, reg_max=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1.5, (B, H // s, W // s, 4 * reg_max + C))
            .astype(np.float32) for s in (8, 16, 32)]


def test_v8_loss_assignment_and_gradient_match_jax():
    """``tal_assign`` (assigned box, foreground, normalised alignment) and
    ``v8_detection_loss`` with its gradient w.r.t. the three head maps."""
    maps = _v8_maps(0)
    gt, gv = _gt()
    fn = functools.partial(JV8.v8_detection_loss, input_hw=(H, W),
                           num_classes=2)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda ms: fn(ms, jnp.asarray(gt), jnp.asarray(gv))))(
        [jnp.asarray(m) for m in maps])
    tmaps = [torch.from_numpy(m).requires_grad_(True) for m in maps]
    tloss = TV8.v8_detection_loss(tmaps, torch.from_numpy(gt),
                                  torch.from_numpy(gv), (H, W), 2)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    for t, j in zip(tmaps, jgrad):
        _close_grad(t.grad, j)

    # the assignment, on the decoded predictions of the same maps
    anchors, strides = JV8._anchor_points((H, W))
    rng = np.random.default_rng(1)
    A = anchors.shape[0]
    scores = rng.uniform(0, 1, (2, A, 2)).astype(np.float32)
    ctr = np.asarray(anchors)[None] + rng.normal(0, 4, (2, A, 2))
    wh = rng.uniform(8, 40, (2, A, 2))
    pred = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(
        np.float32)
    gxy = np.concatenate([gt[..., :2] - gt[..., 2:4] / 2,
                          gt[..., :2] + gt[..., 2:4] / 2], -1)
    want = jax.jit(jax.vmap(JV8.tal_assign, in_axes=(0, 0, None, 0, 0, 0)))(
        scores, pred, anchors, gxy, gt[..., 4].astype(np.int32), gv)
    got = TV8.tal_assign(torch.from_numpy(scores), torch.from_numpy(pred),
                         torch.from_numpy(np.asarray(anchors)),
                         torch.from_numpy(gxy),
                         torch.from_numpy(gt[..., 4]).int(),
                         torch.from_numpy(gv))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    fg = got[1].numpy()
    assert 4 <= fg.sum() < A
    np.testing.assert_array_equal(got[0].numpy()[fg], np.asarray(want[0])[fg])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-7)


def _detr_outputs(seed, B, Q, C):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 1.5, (B, Q, C)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (B, Q, 2)),
                            rng.uniform(0.1, 0.5, (B, Q, 2))], -1).astype(
        np.float32)
    return logits, boxes


@functools.lru_cache(maxsize=None)
def _jax_matching():
    return jax.jit(jax.vmap(lambda c, gv: jmatching(
        c, jnp.ones(c.shape[0], bool), gv, batched=True)))


@pytest.mark.parametrize("Q,G", [(12, 5), (3, 5)],
                         ids=["transposed", "rows_le_cols"])
def test_rtdetr_loss_matching_and_gradient_match_jax(Q, G):
    """The set matching of ``rtdetr_detection_loss`` (one batched call here,
    per image in JAX) on its own costs and on costs with ties, the loss and
    its gradient w.r.t. the logits and boxes."""
    logits, boxes = _detr_outputs(2, 2, Q, 3)
    gt = np.zeros((2, G, 5), np.float32)
    gt[..., :2] = np.random.default_rng(3).uniform(20, 76, (2, G, 2))
    gt[..., 2:4] = np.random.default_rng(4).uniform(10, 40, (2, G, 2))
    gt[..., 4] = np.arange(G) % 3
    gv = np.ones((2, G), bool)
    gv[1, G - 2:] = False
    cost = TRT.matching_costs(torch.from_numpy(logits),
                              torch.from_numpy(boxes), torch.from_numpy(gt),
                              (H, W)).numpy()
    tied = np.round(cost, 0)
    tied[0, :, :2] = 1.0
    for c in (cost, tied):
        want = _jax_matching()(c, gv)
        got = matching_forced(torch.from_numpy(c),
                              torch.ones((2, Q), dtype=torch.bool),
                              torch.from_numpy(gv), batched=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got >= 0).sum() == min(Q, G) + min(Q, G - 2)

    fn = functools.partial(JRT.rtdetr_detection_loss, input_hw=(H, W),
                           num_classes=3)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda o: fn(o, jnp.asarray(gt), jnp.asarray(gv))))(
        (jnp.asarray(logits), jnp.asarray(boxes)))
    tl = torch.from_numpy(logits).requires_grad_(True)
    tb = torch.from_numpy(boxes).requires_grad_(True)
    tloss = TRT.rtdetr_detection_loss((tl, tb), torch.from_numpy(gt),
                                      torch.from_numpy(gv), (H, W), 3)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    _close_grad(tl.grad, jgrad[0])
    _close_grad(tb.grad, jgrad[1])


def test_pose_targets_loss_and_gradient_match_jax():
    """``gaussian_heatmaps`` (an invisible keypoint gives a zero map) and
    ``pose_loss`` with its gradient w.r.t. the heatmap logits."""
    rng = np.random.default_rng(5)
    kp = np.concatenate([rng.uniform(2, 30, (2, 3, 2)),
                         np.array([[[1], [0], [0.7]], [[0.2], [1], [0]]])],
                        -1).astype(np.float32)
    logits = rng.normal(0, 1, (2, 16, 8, 3)).astype(np.float32)
    want = jax.vmap(lambda k: JPT.gaussian_heatmaps(k, (16, 8), (64, 32)))(
        kp)
    got = TPT.gaussian_heatmaps(torch.from_numpy(kp), (16, 8), (64, 32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert float(got[0, ..., 1].abs().max()) == 0
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda lg: JPT.pose_loss(lg, jnp.asarray(kp), (64, 32))))(logits)
    tl = torch.from_numpy(logits).requires_grad_(True)
    tloss = TPT.pose_loss(tl, torch.from_numpy(kp), (64, 32))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    _close_grad(tl.grad, jgrad)


# ------------------------------------------------------ one training step
def _images(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.uint8)


def _family(name):
    """(JAX model, its variables, port model, converter, JAX loss and
    preproc, port loss and preproc, input hw, lr, optimizer)."""
    if name == "yolov8n":
        jm = JYOLOv8(num_classes=2, variant="n")
        v = yolo_variables(jm, H, seed=6)
        tm = YOLOv8(num_classes=2, variant="n", device="cpu")
        jdet = JYOLOv8Detector(num_classes=2)
        jdet._model = jm
        tdet = YOLOv8Detector(num_classes=2, device="cpu")
        tdet._model = tm
        return (jm, v, tm, yolov8_from_flax, jdet.detection_loss_fn,
                jdet._preproc, tdet.detection_loss_fn, tdet._preproc,
                (H, W))
    if name == "rtdetr_nano":
        kw = dict(num_classes=2, num_queries=12, dim=64, dec_layers=1,
                  variant="nano")
        jm = JRTDETR(**kw)
        v = rtdetr_variables(jm, (1, H, W, 3), seed=7, train=False)
        tm = RTDETR(input_size=(H, W), device="cpu", **kw)
        tdet = RTDETRDetector(variant="nano", num_classes=2, device="cpu")
        jdet = JRA.RTDETRDetector(variant="nano", num_classes=2)
        return (jm, v, tm, rtdetr_from_flax, jdet.detection_loss_fn,
                jdet._preproc, tdet.detection_loss_fn, tdet._preproc,
                (H, W))
    if name == "rtdetr_hf_tiny":
        jm = JH.RTDetrHF(config=JH.RTDetrHFConfig(**HF_TINY), num_labels=3)
        v = rtdetr_variables(jm, (1, 128, 128, 3), seed=8)
        tm = TH.RTDetrHF(config=TH.RTDetrHFConfig(**HF_TINY), device="cpu")
        tdet = RTDETRDetector(variant="r18vd", num_classes=3, device="cpu")
        jdet = JRA.RTDETRDetector(variant="r18vd", num_classes=3)
        return (jm, v, tm, rtdetr_hf_from_flax, jdet.detection_loss_fn,
                jdet._preproc, tdet.detection_loss_fn, tdet._preproc,
                (128, 128))
    jm = JTopDownPose(num_keypoints=2, variant="nano")
    v = pose_variables(jm, (1, 64, 32, 3), seed=9, head="^params/Conv_0/")
    tm = TopDownPose(num_keypoints=2, variant="nano", device="cpu")
    return (jm, v, tm, topdownpose_from_flax, None, None, None, None,
            (64, 32))


def _jax_step(jm, v, loss_fn, preproc, batch, hw, lr, pose):
    """JAX's step as ``train_detector`` (AdamW) or tests/test_models.py's
    pose step (Adam) takes it, returning the loss, the gradients, the
    parameters after the update and the BN statistics."""
    tx = optax.adam(lr) if pose else optax.adamw(lr)
    n_cls = getattr(jm, "num_classes", getattr(jm, "num_labels", None))

    def step(params, stats, x, a, b):
        def lf(p):
            outs, mut = jm.apply({"params": p, "batch_stats": stats},
                                 x if pose else preproc(x), train=True,
                                 mutable=["batch_stats"])
            loss = (JPT.pose_loss(outs, a, hw) if pose
                    else loss_fn(outs, a, b, hw, n_cls))
            return loss, mut["batch_stats"]

        (loss, bs), g = jax.value_and_grad(lf, has_aux=True)(params)
        upd, _ = tx.update(g, tx.init(params), params)
        return loss, g, optax.apply_updates(params, upd), bs

    return jax.jit(step)(v["params"], v.get("batch_stats", {}), *batch)


FAMILIES = ["yolov8n", "rtdetr_nano", "rtdetr_hf_tiny", "topdown_nano"]


# per family, the bound on every leaf's and on the median leaf's gradient
# gap, in units of the leaf's largest magnitude (see the test's note)
BOUNDS = {"yolov8n": (5e-4, 2e-4), "rtdetr_nano": (5e-4, 2e-4),
          "rtdetr_hf_tiny": (1e-4, 1e-5), "topdown_nano": (0.2, 5e-2)}
# a key projection's bias shifts every logit of a query's row alike, so
# softmax cancels it: its gradient is zero but for rounding
ROUNDING_ONLY = ("attn.key.bias", "self_attn.k_proj.bias")


@pytest.mark.parametrize("name", FAMILIES)
def test_first_step_matches_jax(name):
    """One step from the same variables: the loss within 1e-5 relative;
    each gradient within ``BOUNDS`` of its leaf's largest magnitude; the
    parameters after the step within 1e-6 where the gradient is sure to a
    tenth (the step is lr * g / (|g| + eps)), else within 2 lr; the BN
    running statistics within 1e-3 of their largest magnitude (HF's frozen
    ones unchanged).

    The bounds: BN on the batch's statistics amplifies f32 rounding where a
    channel has few values. YOLOv8n and RT-DETR-nano at 96 x 96 (18 values
    a channel at stride 32) part by up to 2.1e-4 (median 1.1e-4), the HF
    tiny configuration (frozen BN) by 2.9e-5. TopDownPose-nano on JAX's
    test size, 64 x 32 crops in a batch of 2, normalises 4 values a channel
    at stride 32: it parts by up to 0.144 (median 2.4e-2), and on 256 x 192
    crops in a batch of 4 by 2.9e-2 (7.3e-3) with equal losses, as XLA's
    own OSNet gradients move under a mere permutation of the batch
    (tests/test_torch_reid_train.py)."""
    jm, v, tm, convert, jloss_fn, jpre, tloss_fn, tpre, hw = _family(name)
    worst, median = BOUNDS[name]
    pose = name == "topdown_nano"
    lr = 1e-3 if pose else 1e-4
    tm.load_state_dict(convert(v), strict=True)
    if pose:
        crops = np.random.default_rng(10).uniform(0, 1, (2,) + hw + (3,)) \
            .astype(np.float32)
        kps = np.random.default_rng(11).uniform(5, 25, (2, 2, 3)).astype(
            np.float32)
        kps[..., 2] = 1.0
        batch = (crops, kps, kps)
    else:
        gt, gv = _gt(size=hw[0])
        batch = (_images(12, (2,) + hw + (3,)), gt, gv)
    jloss, jgrads, jafter, jstats = _jax_step(jm, v, jloss_fn, jpre, batch,
                                              hw, lr, pose)
    if pose:
        state = TPT.create_pose_train_state(
            tm, functools.partial(torch.optim.Adam, lr=lr))
        state, tloss = TPT.make_pose_train_step(hw)(state, {
            "crops": torch.from_numpy(batch[0]),
            "keypoints": torch.from_numpy(batch[1])})
    else:
        state = create_train_state(tm, functools.partial(
            torch.optim.AdamW, lr=lr, weight_decay=1e-4))
        step = make_train_step(hw, tloss_fn, tpre)
        state, tloss = step(state, {"images": torch.from_numpy(batch[0]),
                                    "gt_boxes": torch.from_numpy(batch[1]),
                                    "gt_valid": torch.from_numpy(batch[2])})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    jg = {k: t.numpy() for k, t in convert({"params": jgrads}).items()}
    before = {k: t.numpy() for k, t in convert(v).items()}
    after = {k: t.numpy() for k, t in convert(
        {"params": jafter, "batch_stats": jstats}).items()}
    rel = []
    floor = 1e-5 * max(np.abs(g).max() for g in jg.values())
    for k, p in tm.named_parameters():
        g, tg = jg[k], (p.grad if p.grad is not None
                        else torch.zeros_like(p)).numpy()
        scale = np.abs(g).max()
        if scale <= floor:
            assert np.abs(tg).max() <= floor, k
        else:
            rel.append(np.abs(tg - g).max() / scale)
            assert rel[-1] <= worst, (k, rel[-1])
        sure = (np.abs(g) > 10 * worst * scale) & (not k.endswith(
            ROUNDING_ONLY))
        got = p.detach().numpy()
        np.testing.assert_allclose(got[sure], after[k][sure], rtol=0,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got, after[k], rtol=0,
                                   atol=2 * lr * (1 + 1e-4) + 1e-7,
                                   err_msg=k)
        assert np.abs(after[k] - before[k]).max() <= lr * (1 + 1e-3) + 1e-7
    assert np.median(rel) <= median, np.median(rel)
    own = tm.state_dict()
    for k, want in after.items():
        if "running" in k:
            np.testing.assert_allclose(own[k].numpy(), want, rtol=0,
                                       atol=1e-3 * np.abs(want).max(),
                                       err_msg=k)
            if name == "rtdetr_hf_tiny":   # HF's BatchNorms stay frozen
                np.testing.assert_array_equal(own[k].numpy(), before[k])


# ------------------------------------------------------- the wrappers
TREE_KW = dict(input_size=(64, 64), min_confidence=0.3, batch_size=4)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _four_image_tree(tmp_path_factory.mktemp("det_tree"))


@pytest.mark.parametrize("make", [
    lambda: YOLOv8Detector(variant="n", num_classes=1, device="cpu",
                           **TREE_KW),
    lambda: YOLOv8Detector(variant="11n", num_classes=1, device="cpu",
                           **TREE_KW),
    lambda: RTDETRDetector(variant="nano", num_classes=1, num_queries=12,
                           device="cpu", **TREE_KW),
    lambda: _hf_detector()], ids=["yolov8n", "yolo11n", "rtdetr", "rtdetr_hf"])
def test_wrapper_trains_then_detects(tree, make):
    """``train`` (``train_detector``, one epoch of one batch of four): the
    loss is finite, the weights move, ``training_enabled`` stays False as
    in JAX, and the next ``process`` detects with the trained model."""
    det = make()
    assert not det.training_enabled
    det._build()
    before = {k: v.clone() for k, v in det._model.state_dict().items()}
    res = det.train(tree, epochs=1, batch_size=4)
    assert len(res["loss"]) == 1 and np.isfinite(res["loss"]).all()
    assert any(not torch.equal(before[k], v)
               for k, v in det._model.state_dict().items())
    assert det._detect is None and not det._model.training
    meta = tree.sets["train"].image_metadatas
    batch = {k: np.stack([f[k] for f in (
        det.preprocess(np.full((80, 96, 3), 90, np.uint8), None, None)
        for _ in range(4))]) for k in ("image", "scale", "pad", "shape")}
    det.process(batch, None, meta)


def _hf_detector():
    det = RTDETRDetector(variant="r18vd", num_classes=3, device="cpu",
                         **TREE_KW)
    det._make_model = lambda: TH.RTDetrHF(
        config=TH.RTDetrHFConfig(**HF_TINY), device="cpu")
    return det


@pytest.mark.parametrize("kw", [dict(num_queries=600), dict(max_gt=513)],
                         ids=["queries", "max_gt"])
def test_rtdetr_train_beyond_k2_raises(tree, kw):
    """Past K2's 512 columns the matching could not run on the card: the
    wrapper raises before the first step (it never takes the plain
    solver instead), and the model is untouched."""
    det = RTDETRDetector(variant="nano", num_classes=1, device="cpu",
                         num_queries=kw.get("num_queries", 12), **TREE_KW)
    det._build()
    before = {k: v.clone() for k, v in det._model.state_dict().items()}
    with pytest.raises(ValueError, match="512"):
        det.train(tree, epochs=1, **{k: v for k, v in kw.items()
                                     if k == "max_gt"})
    for k, v in det._model.state_dict().items():
        assert torch.equal(before[k], v)


def test_rtmdet_train_raises_in_both_packages(tree):
    """JAX's ``RTMDetDetector`` inherits YOLOX's ``train``, whose SimOTA
    loss reads (B, H, W, 5 + C) maps and gets RTMDet's (cls, reg) pairs:
    its step fails at its trace. The port raises before the step."""
    jdet = JRTMDetDetector(input_size=(64, 64))
    jm = JRTMDet(num_classes=1, variant="nano")
    jdet._variables = yolo_variables(jm, 64, seed=1, full=False)
    with pytest.raises(AttributeError, match="shape"):
        jdet.train(tree, epochs=1)
    det = RTMDetDetector(input_size=(64, 64), device="cpu")
    with pytest.raises(TypeError, match="RTMDet"):
        det.train(tree, epochs=1)


def test_rtmdet_train_mode_matches_jax():
    """RTMDet's train mode (which its ``train`` never reaches, as in JAX):
    the head maps on the batch's statistics and the BN running statistics
    after one forward with mmdet's momentum 0.9."""
    from tracklab_torch.models.convert import rtmdet_from_flax
    jm = JRTMDet(num_classes=1, variant="nano")
    v = yolo_variables(jm, 64, seed=2)
    x = np.random.default_rng(3).normal(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    outs, mut = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, x)
    tm = RTMDet(num_classes=1, variant="nano", device="cpu")
    tm.load_state_dict(rtmdet_from_flax(v), strict=True)
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for (gc, gr), (wc, wr) in zip(got, outs):
        for g, w in ((gc, wc), (gr, wr)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w,
                                       rtol=0, atol=2e-3 * np.abs(w).max())
    want = rtmdet_from_flax({"params": v["params"],
                             "batch_stats": mut["batch_stats"]})
    own = tm.state_dict()
    for k, w in want.items():
        if "running" in k:
            w = w.numpy()
            np.testing.assert_allclose(own[k].numpy(), w, rtol=0,
                                       atol=1e-3 * np.abs(w).max(),
                                       err_msg=k)
