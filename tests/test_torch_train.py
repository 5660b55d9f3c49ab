"""YOLOX training in the port against the JAX package on the CPU: the
SimOTA detection loss (positives equal, loss within 1e-5 relative, its
gradient with respect to the head's maps within 1e-4 of its scale), one
``make_train_step`` of YOLOX-nano at 64 x 64 from JAX's PRNGKey(0) weights
(every gradient and the parameters after one AdamW step), ``train_detector``
through both packages' YOLOX wrappers on a four-image tree (the loss per
epoch, the BN running statistics), and ``train_tracking=true`` on the
port's command line, which trains the ReID and not the detector, as the
JAX package's does.

JAX compiles one training step here (``train_detector``'s, which is
``make_train_step``'s apply, loss and AdamW), and the loss twice (with and
without SimOTA)."""
import functools
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from tracklab_tpu.models import train as JT
from tracklab_tpu.models.yolox import decode_outputs as jdecode
from tracklab_tpu.wrappers.bbox_detector.yolox_api import \
    YOLOXDetector as JYOLOXDetector
from tracklab_torch import main as TM
from tracklab_torch.models import train as TT
from tracklab_torch.models.convert import yolox_from_flax
from tracklab_torch.wrappers.bbox_detector.yolox_api import YOLOXDetector
from test_torch_yolox import jax_yolox_prng0

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

SIZE = 64
LR = 1e-4


def _head_maps(seed, B=2, C=2, tie_level0=False):
    """Seeded raw head maps (B, h, w, 5 + C) at strides 8, 16, 32 of a
    64 x 64 input. With ``tie_level0`` every stride-8 anchor predicts the
    same box (centre (28, 28), 24 x 24) and scores, so SimOTA's costs tie
    there and the stable order decides."""
    rng = np.random.default_rng(seed)
    maps = []
    for s in (8, 16, 32):
        h = SIZE // s
        m = rng.normal(0.0, 1.0, (B, h, h, 5 + C)).astype(np.float32)
        m[..., 2:4] = rng.uniform(0.5, 1.8, (B, h, h, 2))
        maps.append(m)
    if tie_level0:
        gy, gx = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
        maps[0][..., 0] = 3.5 - gx
        maps[0][..., 1] = 3.5 - gy
        maps[0][..., 2:4] = np.log(3.0)
        maps[0][..., 4:] = 0.25
    return maps


def _gt(B=2, C=2):
    """(B, 4, 5) boxes [cx, cy, w, h, cls] in input pixels, two of them
    overlapping (anchors claimed twice), the last slot of image 1 unused."""
    boxes = np.array([[[28, 28, 30, 26, 0], [34, 30, 24, 30, 1],
                       [12, 50, 14, 16, 1], [48, 12, 40, 18, 0]],
                      [[20, 20, 16, 22, 1], [44, 40, 34, 30, 0],
                       [40, 44, 12, 12, 1], [0, 0, 0, 0, 0]]], np.float32)
    valid = np.array([[True] * 4, [True, True, True, False]])
    return boxes[:B], valid[:B]


def _jax_positives(maps, boxes, valid, C):
    """JAX's per-image assignment (train.py's center prior, then
    ``_simota_assign``), vmapped over the batch."""
    dec = jdecode([jnp.asarray(m) for m in maps], apply_sigmoid=False)
    centers, strides = JT._anchor_centers((SIZE, SIZE))

    def one(d, b, v):
        gx, gy, gw, gh = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
        cx, cy = centers[:, 0][:, None], centers[:, 1][:, None]
        in_box = ((cx > (gx - gw / 2)[None]) & (cx < (gx + gw / 2)[None])
                  & (cy > (gy - gh / 2)[None]) & (cy < (gy + gh / 2)[None]))
        r = 2.5 * strides[:, None]
        in_center = ((jnp.abs(cx - gx[None]) < r)
                     & (jnp.abs(cy - gy[None]) < r))
        pos = in_box & in_center & v[None, :]
        iou = JT._pairwise_iou_xywh(d[:, :4], b[:, :4])
        return pos, JT._simota_assign(pos, iou, d[:, 5:], d[:, 4],
                                      b[:, 4].astype(jnp.int32), v, C)

    return jax.jit(jax.vmap(one))(dec, jnp.asarray(boxes), jnp.asarray(valid))


def _torch_positives(maps, boxes, valid, C):
    from tracklab_torch.models.yolox import decode_outputs
    dec = decode_outputs([torch.from_numpy(m) for m in maps],
                         apply_sigmoid=False)
    centers, strides = TT._anchor_centers((SIZE, SIZE))
    b, v = torch.from_numpy(boxes), torch.from_numpy(valid)
    cx, cy = centers[:, 0][None, :, None], centers[:, 1][None, :, None]
    gx, gy = b[..., 0][:, None], b[..., 1][:, None]
    gw, gh = b[..., 2][:, None], b[..., 3][:, None]
    in_box = ((cx > gx - gw / 2) & (cx < gx + gw / 2)
              & (cy > gy - gh / 2) & (cy < gy + gh / 2))
    r = 2.5 * strides[None, :, None]
    pos = (in_box & (torch.abs(cx - gx) < r) & (torch.abs(cy - gy) < r)
           & v[:, None, :])
    iou = TT._pairwise_iou_xywh(dec[..., :4], b[..., :4])
    return pos, TT._simota_assign(pos, iou, dec[..., 5:], dec[..., 4],
                                  b[..., 4].long(), v, C)


@pytest.mark.parametrize("tie_level0", [False, True])
def test_simota_positives_equal_jax(tie_level0):
    """The centre prior and SimOTA's positives equal JAX's, on random maps
    and on maps whose stride-8 costs all tie; the assignment is not
    trivial (several candidates per box, an anchor claimed twice)."""
    maps = _head_maps(0, tie_level0=tie_level0)
    boxes, valid = _gt()
    jpos, jsim = _jax_positives(maps, boxes, valid, 2)
    tpos, tsim = _torch_positives(maps, boxes, valid, 2)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tsim.numpy(), np.asarray(jsim))
    assert (tpos.sum(1) > 1).any() and (tpos.sum(2) > 1).any()
    assert 0 < tsim.sum() < tpos.sum()


@pytest.mark.parametrize("simota", [True, False])
def test_detection_loss_and_gradient_match_jax(simota):
    """``detection_loss`` and its gradient with respect to every head map:
    loss within 1e-5 relative of JAX's, the gradient within 1e-4 of its
    largest magnitude."""
    maps = _head_maps(1)
    boxes, valid = _gt()
    loss_fn = functools.partial(JT.detection_loss, input_hw=(SIZE, SIZE),
                                num_classes=2, simota=simota)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda ms: loss_fn(ms, jnp.asarray(boxes), jnp.asarray(valid))))(
        [jnp.asarray(m) for m in maps])
    tmaps = [torch.from_numpy(m).requires_grad_(True) for m in maps]
    tloss = TT.detection_loss(tmaps, torch.from_numpy(boxes),
                              torch.from_numpy(valid), (SIZE, SIZE), 2,
                              simota=simota)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    for level, (t, j) in enumerate(zip(tmaps, jgrad)):
        j = np.asarray(j)
        scale = np.abs(j).max()
        assert scale > 0
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=0,
                                   atol=1e-4 * scale, err_msg=str(level))


def _four_image_tree(root):
    """Four 96 x 80 PNG frames (so the letterbox scales and pads) with two
    or three ground-truth boxes each, as a duck-typed tracking dataset both
    packages' ``train_detector`` read."""
    rng = np.random.default_rng(11)
    images, gt = [], []
    for i in range(4):
        img = rng.integers(0, 60, (80, 96, 3), np.uint8)
        for j in range(2 + i % 2):
            l, t = rng.integers(4, 50), rng.integers(4, 40)
            w, h = rng.integers(14, 36), rng.integers(18, 34)
            img[t:t + h, l:l + w] = rng.integers(150, 255, 3)
            gt.append(dict(image_id=i, video_id=0, category_id=1,
                           bbox_ltwh=np.array([l, t, w, h], np.float32)))
        path = root / f"{i:06d}.png"
        cv2.imwrite(str(path), img[..., ::-1])
        images.append(dict(id=i, video_id=0, frame=i + 1,
                           file_path=str(path)))
    ts = types.SimpleNamespace(
        image_metadatas=pd.DataFrame(images).set_index("id"),
        detections_gt=pd.DataFrame(gt))
    return types.SimpleNamespace(sets={"train": ts})


KW = dict(variant="nano", num_classes=1, input_size=(SIZE, SIZE),
          min_confidence=0.3, batch_size=4)
EPOCHS = 3


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages' ``YOLOXDetector.train`` (``train_detector``: 3 epochs
    of one batch of the four images, AdamW 1e-4) from JAX's PRNGKey(0)
    YOLOX-nano at 64 x 64, each optimizer step's gradients and parameters
    recorded (JAX: through ``optax.adamw``'s update, train_detector's step
    being make_train_step's apply, loss and AdamW; the port: around
    ``torch.optim.AdamW.step``). JAX compiles its step once here.

    The port's later steps start from JAX's parameters (teacher forcing):
    Adam's first step moves each parameter by about lr * sign(gradient),
    and where the gradient lies below f32 rounding (~450 of ~900k
    parameters here) the two packages' signs differ; from there the two
    runs part, by ~1 % in loss within three steps, although the port's
    loss and gradients at JAX's parameters stay within 2e-5 relative and
    1.4e-3 of scale of JAX's at every step."""
    root = tmp_path_factory.mktemp("train_tree")
    dataset = _four_image_tree(root)
    variables = jax_yolox_prng0(tmp_path_factory, "nano")
    jsteps, tsteps = [], []
    real_adamw = optax.adamw

    def recording_adamw(lr):
        tx = real_adamw(lr)

        def update(grads, state, params=None):
            jax.debug.callback(lambda g, p: jsteps.append(
                jax.tree_util.tree_map(np.asarray, (g, p))), grads, params)
            return tx.update(grads, state, params)

        return optax.GradientTransformation(tx.init, update)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(optax, "adamw", recording_adamw)
        jmod = JYOLOXDetector(**KW)
        jmod._variables = variables
        jres = jmod.train(dataset, epochs=EPOCHS, batch_size=4)
    torch.save(yolox_from_flax(jax.tree_util.tree_map(np.asarray,
                                                      variables)),
               root / "prng0.pt")
    tmod = YOLOXDetector(checkpoint_path=str(root / "prng0.pt"),
                         device="cpu", **KW)
    tmod._build()
    names = [k for k, _ in tmod._model.named_parameters()]
    views = [_port_view(p, "params") for _, p in jsteps]
    forced = [[torch.from_numpy(v[k]) for k in names] for v in views]

    class TeacherForcedAdamW(torch.optim.AdamW):
        def step(self, closure=None):
            params = self.param_groups[0]["params"]
            grads = [p.grad.clone() for p in params]
            out = super().step(closure)
            tsteps.append((dict(zip(names, grads)), dict(zip(
                names, (p.detach().clone() for p in params)))))
            if len(tsteps) < len(forced):
                with torch.no_grad():
                    for p, v in zip(params, forced[len(tsteps)]):
                        p.copy_(v)
            return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.optim, "AdamW", TeacherForcedAdamW)
        tres = tmod.train(dataset, epochs=EPOCHS, batch_size=4)
    return dict(dataset=dataset, root=root, jmod=jmod, jres=jres,
                jsteps=jsteps, tmod=tmod, tres=tres, tsteps=tsteps)


def _port_view(tree, collection):
    return {k: v.numpy() for k, v in yolox_from_flax({collection: tree})
            .items()}


def test_first_step_matches_jax(trained):
    """The first step (``make_train_step`` in the port) on the four
    letterboxed images: gradients and the parameters after AdamW.

    Tolerances, from f32 rounding: BN on the batch's statistics (16 values
    a channel at stride 32) over raw 0-255 pixels amplifies it, and each
    package's f32 gradients lie up to ~1.1e-3 of a leaf's largest magnitude
    from a float64 run of the port at this size. So every gradient leaf
    within 3e-3 of its largest magnitude; the parameters after the step
    within two f32 ulps plus 1e-4 of the step's size lr of JAX's where the
    gradient is sure to a tenth (|g| above ten times the gradient
    tolerance: the step is lr * g / (|g| + eps)), elsewhere within two of
    the step's largest moves, 2 lr (1 + weight decay); and they equal
    optax's AdamW step from the port's own gradients within two ulps plus
    1e-6 of lr (the f32 rounding of the step itself)."""
    assert len(trained["jsteps"]) == len(trained["tsteps"]) == EPOCHS
    jgrads, jparams = trained["jsteps"][0]
    tgrads, tafter = trained["tsteps"][0]
    jgrads = _port_view(jgrads, "params")
    before = _port_view(jparams, "params")
    after = _port_view(trained["jsteps"][1][1], "params")
    assert set(jgrads) == set(tgrads)
    sure = 0
    for k, g in jgrads.items():
        tol = 3e-3 * np.abs(g).max()
        np.testing.assert_allclose(tgrads[k].numpy(), g, rtol=0,
                                   atol=tol + 1e-12, err_msg=k)
        got = tafter[k].numpy()
        mask = np.abs(g) > 10 * tol
        sure += int(mask.sum())
        np.testing.assert_allclose(got[mask], after[k][mask], rtol=2.4e-7,
                                   atol=1e-4 * LR, err_msg=k)
        np.testing.assert_allclose(got, after[k], rtol=0,
                                   atol=2 * LR * (1 + 1e-4), err_msg=k)
        np.testing.assert_array_less(np.abs(after[k] - before[k]),
                                     LR * (1 + 1e-4) + 1e-7)
        tg = tgrads[k].numpy().astype(np.float64)
        adamw = before[k] - LR * (tg / (np.abs(tg) + 1e-8)
                                  + 1e-4 * before[k])
        np.testing.assert_allclose(got, adamw, rtol=2.4e-7, atol=1e-6 * LR,
                                   err_msg=k)
    assert sure > 0.5 * sum(g.size for g in jgrads.values())


def test_train_detector_matches_jax(trained):
    """``train_detector`` through both wrappers (the port's later steps
    from JAX's parameters, see ``trained``): each epoch's loss within 1e-4
    relative of JAX's, the BN running statistics after the run within
    1e-3 of each statistic's largest magnitude (the forwards' f32
    rounding, as for the gradients). After it the port's
    wrapper detects with the trained model: its rows equal those of a
    fresh wrapper loading the trained state dict."""
    tres, jres, tmod = trained["tres"], trained["jres"], trained["tmod"]
    assert len(tres["loss"]) == len(jres["loss"]) == EPOCHS
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=1e-4)
    assert len(set(tres["loss"])) == EPOCHS
    # train_tracking=true trains the detector in neither package
    assert tmod.training_enabled == trained["jmod"].training_enabled
    assert not tmod.training_enabled
    assert tmod._detect is None and not tmod._model.training
    own = tmod._model.state_dict()
    for k, v in _port_view(trained["jmod"]._variables["batch_stats"],
                           "batch_stats").items():
        np.testing.assert_allclose(own[k].numpy(), v, rtol=0,
                                   atol=1e-3 * np.abs(v).max(), err_msg=k)

    root = trained["root"]
    torch.save(own, root / "trained.pt")
    tmod.min_confidence = 0.02
    fresh = YOLOXDetector(checkpoint_path=str(root / "trained.pt"),
                          device="cpu", **dict(KW, min_confidence=0.02))
    from tracklab_torch.wrappers.bbox_detector.yolox_api import letterbox
    meta = trained["dataset"].sets["train"].image_metadatas
    frames = [letterbox(cv2.imread(p)[..., ::-1], (SIZE, SIZE))
              for p in meta["file_path"]]
    batch = {k: np.stack([f[k] for f in frames]) for k in frames[0]}
    got, want = (m.process(batch, None, meta) for m in (tmod, fresh))
    pd.testing.assert_frame_equal(got, want)
    assert len(got)


def test_cli_train_tracking_trains_then_tracks(tmp_path):
    """``train_tracking=true`` on the port's command line with YOLOX-nano ->
    OSNet x0_25 -> StrongSORT, as the JAX package's ``main.py`` runs it: the
    ReID trains on the synthetic set's ground truth (one epoch: the spy
    around ``OSNetReId.train`` asks ``train_reid`` for it; its weights move,
    the loss is finite), the detector does not (``training_enabled`` is
    False, as in JAX: its weights stay as they were), then the run tracks
    with the trained OSNet and is evaluated."""
    from tracklab_torch.wrappers.reid import OSNetReId

    seen = {}
    real = OSNetReId.train

    def spy(self, *a, **kw):
        self._build()
        seen["before"] = {k: v.clone()
                          for k, v in self._model.state_dict().items()}
        out = real(self, *a, **dict(kw, epochs=1))
        seen["loss"], seen["reid"] = out["loss"], self
        return out

    det_train = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(OSNetReId, "train", spy)
        mp.setattr(YOLOXDetector, "train",
                   lambda self, *a, **kw: det_train.append(self))
        parts, results = TM.main([
            "device=cpu", "train_tracking=true", "use_rich=false",
            "pipeline=[bbox_detector,reid,track]",
            "+modules/bbox_detector=yolox",
            "modules.bbox_detector.variant=nano",
            "modules.bbox_detector.input_size=[64,64]",
            "modules.bbox_detector.min_confidence=0.2",
            "modules.bbox_detector.max_dets=16",
            "modules.bbox_detector.batch_size=4",
            "+modules/reid=osnet", "modules.reid.variant=x0_25",
            "modules.reid.feat_dim=32", "modules.reid.crop_size=[64,32]",
            "modules.reid.use_parts=false", "modules.reid.batch_size=8",
            "modules/track=strong_sort", "modules.track.embed_dim=32",
            "modules.track.min_confidence=0", "modules.track.max_dets=16",
            "modules.track.max_tracks=32", "dataset.n_videos=1",
            "dataset.n_frames=8", "dataset.n_objects=3",
            "dataset.img_w=64", "dataset.img_h=64"])
    detector = next(m for m in parts["modules"]
                    if isinstance(m, YOLOXDetector))
    fresh = YOLOXDetector(device="cpu", **KW)
    fresh._build()
    own = detector._model.state_dict()
    assert not det_train and all(torch.equal(own[k], v) for k, v in
                                 fresh._model.state_dict().items())
    reid = seen["reid"]
    assert len(seen["loss"]) == 1 and np.isfinite(seen["loss"]).all()
    assert reid._model is reid._trained
    assert any(not torch.equal(seen["before"][k], v)
               for k, v in reid._model.state_dict().items())
    assert parts["tracker_state"].detections_pred["track_id"].notna().any()
    assert results is not None
