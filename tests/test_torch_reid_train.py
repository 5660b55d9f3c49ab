"""ReID training in the port against the JAX package on the CPU, with the
wrappers' ``training_enabled`` and K4's autograd Function.

- ``training_enabled`` of every port wrapper class equals its JAX
  counterpart's.
- ``VitAttentionFn``'s backward equals autograd of both plain attentions
  (f32 and compute-dtype softmax), with and without ``n_valid``: within
  1e-6 of each gradient's largest magnitude in float64, 1e-5 in f32.
- ``_gather_crops`` and ``build_reid_set`` read the same frames and write
  the same crops as JAX's on test_dataset_splits.py's
  ``make_multi_video_set`` tree (frames rendered here).
- ``OSNetReId.train`` (``train_reid``: OSNet x0_25 at 64 x 32, 2 epochs of
  batches of 8) and ``KPReId.train`` (``train_kpr``: a depth-2 ViT) through
  both packages' wrappers from the same initial variables: the first
  step's loss within 1e-5 relative and every gradient within 1e-4 of its
  largest magnitude; each epoch's loss within 1e-4 relative with the port's
  later steps started from JAX's parameters (teacher forcing: Adam's first
  step is about lr * sign(gradient), which sub-rounding gradients flip);
  the BN running statistics after the run.
- ``OSNetReId(backbone=...)`` after ``train``: both packages' next
  ``process`` raises (a reference fault, ROADMAP section 3).
- ``train_tracking=true`` on the port's command line with KPR.

JAX compiles one training step per family (``train_reid``'s and
``train_kpr``'s); the flax ``init`` inside them is replaced by seeded numpy
draws on the trees' shapes (no init program is compiled), and the port's
``initial_model`` by those variables.
"""
import functools
import importlib
import inspect
import pkgutil
import types

import cv2
import flax.linen as fnn
import jax
import numpy as np
import optax
import pandas as pd
import pytest
import torch

import tracklab_torch
import tracklab_tpu
from test_dataset_splits import make_multi_video_set
from tracklab_torch import main as TM
from tracklab_torch.kernels.vit_attention import (vit_attention,
                                                  vit_attention_compute_plain,
                                                  vit_attention_plain)
from tracklab_torch.models import kpr_train as TKT
from tracklab_torch.models import reid_train as TRT
from tracklab_torch.models.convert import kpr_from_flax, osnet_from_flax
from tracklab_torch.models.kpr import KPR
from tracklab_torch.pipeline.module import Module as TModule
from tracklab_torch.wrappers.reid import KPReId, OSNetReId
from tracklab_torch.wrappers.reid import reid_dataset as TRD
from tracklab_tpu.models import reid_train as JRT
from tracklab_tpu.pipeline.module import Module as JModule
from tracklab_tpu.wrappers.reid import reid_dataset as JRD
from tracklab_tpu.wrappers.reid.kpr_api import KPReId as JKPReId
from tracklab_tpu.wrappers.reid.osnet_api import OSNetReId as JOSNetReId

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)


# ----------------------------------------------------- training_enabled
def _wrapper_classes(pkg, base):
    """{(module path under the package, class name): class} of every
    pipeline module class (detectors, ReID, pose, calibration, trackers,
    ...) defined in ``pkg``."""
    out = {}
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        mod = importlib.import_module(info.name)
        for name, cls in inspect.getmembers(mod, inspect.isclass):
            if cls.__module__ == mod.__name__ and issubclass(cls, base):
                out[(info.name.split(".", 1)[1], name)] = cls
    return out


_PORT = _wrapper_classes(tracklab_torch, TModule)
_JAX = _wrapper_classes(tracklab_tpu, JModule)


def test_every_port_wrapper_has_a_jax_counterpart():
    assert len(_PORT) >= 30
    assert set(_PORT) == set(_JAX), sorted(set(_PORT) ^ set(_JAX))


@pytest.mark.parametrize("key", sorted(_PORT), ids=lambda k: ".".join(k))
def test_training_enabled_equals_jax(key):
    """What ``main.py`` trains under ``train_tracking=true``: the port's
    wrapper exactly where JAX's is (OSNet and KPR, not the detectors)."""
    assert _PORT[key].training_enabled == _JAX[key].training_enabled


# ----------------------------------------------------- K4 under autograd
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-6),
                                       (torch.float32, 1e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("n_valid", [None, 13])
@pytest.mark.parametrize("softmax", ["f32", "compute"])
def test_vit_attention_backward_matches_plain_autograd(dtype, tol, n_valid,
                                                       softmax):
    """dq, dk, dv of the Function (plain forward on the CPU, the backward
    from recomputed probabilities) against autograd through the plain
    version of the same softmax mode; the masked keys get no gradient."""
    g = torch.Generator().manual_seed(7)
    q, k, v, d_out = (torch.randn(2, 21, 3, 16, generator=g, dtype=dtype)
                      for _ in range(4))
    plain = (vit_attention_compute_plain if softmax == "compute"
             else vit_attention_plain)
    grads = []
    for fn in (vit_attention, plain):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, n_valid, softmax=softmax) if fn is vit_attention \
            else fn(*leaves, n_valid)
        assert out.requires_grad
        grads.append(torch.autograd.grad((out * d_out).sum(), leaves))
    for got, want in zip(*grads):
        scale = float(want.abs().max())
        assert scale > 0
        torch.testing.assert_close(got, want, rtol=0, atol=tol * scale)
    if n_valid is not None:
        assert float(grads[0][1][:, n_valid:].abs().max()) == 0
        assert float(grads[0][2][:, n_valid:].abs().max()) == 0


# ------------------------------------------------------- the data tree
CROP = (64, 32)


def _render(root):
    """``make_multi_video_set`` (6 videos x 4 frames, 11 (video, track)
    identities, every box [10, 10, 20, 40]) with each frame rendered to a
    64 x 48 PNG: a seeded texture, the box's person a colour of its own."""
    ts = make_multi_video_set()
    rng = np.random.default_rng(4)
    colours = {p: rng.integers(40, 255, 3) for p in
               ts.detections_gt["person_id"].unique()}
    paths = {}
    for image_id in ts.image_metadatas.index:
        img = rng.integers(0, 80, (64, 48, 3), np.uint8)
        for _, det in ts.detections_gt[
                ts.detections_gt.image_id == image_id].iterrows():
            img[10:50, 10:30] = (colours[det["person_id"]]
                                 + rng.integers(0, 30, (40, 20, 3))) % 256
        path = root / f"{image_id:04d}.png"
        cv2.imwrite(str(path), img[..., ::-1])
        paths[image_id] = str(path)
    ts.image_metadatas["file_path"] = ts.image_metadatas.index.map(paths)
    return ts


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    ts = _render(tmp_path_factory.mktemp("reid_tree"))
    return types.SimpleNamespace(sets={"train": ts})


def test_gather_crops_matches_jax(tree):
    jc, jl = JRT._gather_crops(tree, CROP)
    tc, tl = TRT._gather_crops(tree, CROP)
    assert tc.shape == (44, 64, 32, 3) and tl.max() == 10
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tl, jl)
    jc, jl = JRT._gather_crops(tree, CROP, max_ids=3, max_per_id=2)
    tc, tl = TRT._gather_crops(tree, CROP, max_ids=3, max_per_id=2)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("kw", [{}, dict(max_ids=5, train_ratio=0.4,
                                         max_crops_per_id=3, seed=3)])
def test_build_reid_set_matches_jax(tree, tmp_path, kw):
    """The same rows (paths relative to each package's folder, pids and
    camera ids) and the same crop files, byte for byte."""
    ts = tree.sets["train"]
    jout = JRD.build_reid_set(ts, tmp_path / "jax", (32, 16), **kw)
    tout = TRD.build_reid_set(ts, tmp_path / "port", (32, 16), **kw)
    assert sum(len(d) for d in tout.values()) > 0 and len(tout["query"])
    for split in ("train", "query", "gallery"):
        j, t = jout[split], tout[split]
        assert list(t["path"].str.split("port/").str[1]) == list(
            j["path"].str.split("jax/").str[1])
        assert list(t["pid"]) == list(j["pid"])
        assert list(t["camid"]) == list(j["camid"])
        for a, b in zip(t["path"], j["path"]):
            assert open(a, "rb").read() == open(b, "rb").read()


# ------------------------------------------------------- training runs
def _numpy_init(seed, drawn):
    """A stand-in for ``flax.linen.Module.init``: seeded numpy draws on the
    tree's shapes (He-normal kernels, norm scales and BN variances in
    [0.5, 1.5], other leaves N(0, 0.05)), kept in ``drawn``."""
    real = fnn.Module.init

    def init(self, rngs, *args, **kwargs):
        shapes = jax.eval_shape(functools.partial(real, self, **kwargs),
                                rngs, *args)
        rng = np.random.default_rng(seed)

        def draw(path, a):
            name = path[-1].key
            if name == "kernel":
                fan_in = int(np.prod(a.shape[:-1]))
                return rng.normal(0, np.sqrt(2.0 / fan_in), a.shape).astype(
                    np.float32)
            if name in ("var", "scale"):
                return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            return rng.normal(0, 0.05, a.shape).astype(np.float32)

        drawn["variables"] = jax.tree_util.tree_map_with_path(draw, shapes)
        return drawn["variables"]

    return init


def _recording_adam(jsteps):
    """``optax.adam`` recording each update's gradients and parameters."""
    real = optax.adam

    def adam(lr):
        tx = real(lr)

        def update(grads, state, params=None):
            jax.debug.callback(lambda g, p: jsteps.append(
                jax.tree_util.tree_map(np.asarray, (g, p))), grads, params)
            return tx.update(grads, state, params)

        return optax.GradientTransformation(tx.init, update)

    return adam


def _teacher_forced_adam(names, forced, tsteps):
    """``torch.optim.Adam`` recording each step's gradients and parameters
    and starting the next step from JAX's parameters ``forced``."""

    class Forced(torch.optim.Adam):
        def step(self, closure=None):
            params = self.param_groups[0]["params"]
            grads = [p.grad.clone() if p.grad is not None
                     else torch.zeros_like(p) for p in params]
            out = super().step(closure)
            tsteps.append((dict(zip(names, grads)), dict(zip(
                names, (p.detach().clone() for p in params)))))
            if len(tsteps) < len(forced):
                with torch.no_grad():
                    for p, v in zip(params, forced[len(tsteps)]):
                        p.copy_(v)
            return out

    return Forced


def _run_both(jmod, tmod, tree, view, head_key, model_of, epochs, batch):
    """Train ``jmod`` (JAX, numpy init, recorded Adam) then ``tmod`` (the
    port, from the same variables, teacher-forced Adam). ``view(params,
    batch_stats)`` maps a flax tree to the port's state-dict names of the
    ReID model; ``model_of(variables)`` builds the port's model."""
    jsteps, tsteps, drawn = [], [], {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Module, "init", _numpy_init(5, drawn))
        mp.setattr(optax, "adam", _recording_adam(jsteps))
        jres = jmod.train(tree, None, None, None, epochs=epochs,
                          batch_size=batch)
    inner = "backbone" if head_key == "Dense_0" else "kpr"
    init_bs = drawn["variables"]["batch_stats"]

    def state_dict(params, stats):
        sd = {"model." + k: v for k, v in view(params[inner], stats).items()}
        sd["head.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(params[head_key]["kernel"]).T))
        sd["head.bias"] = torch.from_numpy(np.asarray(
            params[head_key]["bias"]))
        return sd

    first_params = jsteps[0][1]

    def initial_model(module, n_ids, seed=0):
        model = TRT.WithHead(model_of(first_params[inner], init_bs),
                             tmod.arch["dim_reduce_output"]
                             if inner == "kpr" else tmod.feat_dim, n_ids,
                             key="bn_foreg" if inner == "kpr"
                             else "embeddings")
        model.load_state_dict(state_dict(first_params, init_bs))
        return model

    param_names = [n for n, _ in initial_model(tmod, 11).named_parameters()]
    forced = []
    for _, p in jsteps:
        sd = state_dict(p, init_bs)
        forced.append([sd[n].float() for n in param_names])
    with pytest.MonkeyPatch.context() as mp:
        mod = TKT if inner == "kpr" else TRT
        mp.setattr(mod, "initial_model", initial_model)
        mp.setattr(torch.optim, "Adam", _teacher_forced_adam(
            param_names, forced, tsteps))
        tres = tmod.train(tree, epochs=epochs, batch_size=batch)
    return dict(jres=jres, tres=tres, jsteps=jsteps, tsteps=tsteps,
                state_dict=state_dict, init_bs=init_bs)


def _grads_apart(got, want):
    """Per leaf of ``got`` (the port's first-step gradients), the largest
    gap to JAX's over JAX's largest magnitude. Leaves that are zero in JAX
    but for rounding (below 1e-5 of the largest gradient: OSNet's part
    head, which no loss reads, and a Linear bias before a BN) must be so
    here too."""
    rel = {}
    floor = 1e-5 * max(float(want[k].abs().max()) for k in got)
    for k, t in got.items():
        j = want[k].numpy()
        scale = np.abs(j).max()
        if scale <= floor:
            # zero but for rounding (e.g. a Linear bias before a BN)
            assert float(t.abs().max()) <= floor, k
            continue
        rel[k] = float(np.abs(t.numpy() - j).max() / scale)
    return rel


def _check_run(run, epochs, n_steps, worst=0.2, median=2e-2,
               head_tol=1e-4):
    """The first step: every gradient within ``worst`` of its leaf's
    largest magnitude, the median leaf within ``median`` and the identity
    head's within ``head_tol``; each epoch's loss (the last step's) within
    1e-5 relative, the port's later steps from JAX's parameters.

    Why not 1e-4 for every leaf: BN on the batch's statistics over few
    values a channel amplifies f32 rounding, and XLA's CPU gradients of
    OSNet x0_25 at this size move by up to 9.6e-2 of a leaf's largest
    magnitude (median 2.0e-2) when the batch of 8 is merely permuted, the
    port's by 1.3e-4 (4.5e-5); the bounds are JAX's own spread. The head,
    past every BN, stays near f32 rounding."""
    jsteps, tsteps = run["jsteps"], run["tsteps"]
    assert len(jsteps) == len(tsteps) == n_steps
    jgrads = run["state_dict"](jsteps[0][0], run["init_bs"])
    rel = _grads_apart(tsteps[0][0], jgrads)
    assert max(rel.values()) <= worst, max(rel.items(), key=lambda kv: kv[1])
    assert np.median(list(rel.values())) <= median, np.median(
        list(rel.values()))
    assert max(rel["head.weight"], rel["head.bias"]) <= head_tol, rel
    jl, tl = run["jres"]["loss"], run["tres"]["loss"]
    assert len(jl) == len(tl) == epochs and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def _close_stats(got, want, what):
    for k, v in want.items():
        v = v.numpy() if torch.is_tensor(v) else np.asarray(v)
        np.testing.assert_allclose(got[k].numpy(), v, rtol=0,
                                   atol=1e-3 * np.abs(v).max(),
                                   err_msg=f"{what} {k}")


OSNET = dict(variant="x0_25", feat_dim=32, n_parts=4, crop_size=CROP)


def _osnet_view(params, stats):
    bs = stats.get("backbone", stats)
    return osnet_from_flax({"params": params, "batch_stats": bs},
                           n_parts=OSNET["n_parts"], device="cpu").state_dict()


@pytest.fixture(scope="module")
def osnet_run(tree):
    jmod = JOSNetReId(**OSNET)
    tmod = OSNetReId(device="cpu", **OSNET)

    def model_of(params, stats):
        return osnet_from_flax({"params": params,
                                "batch_stats": stats["backbone"]},
                               n_parts=OSNET["n_parts"], device="cpu")

    run = _run_both(jmod, tmod, tree, _osnet_view, "Dense_0", model_of,
                    epochs=2, batch=8)
    return dict(run, jmod=jmod, tmod=tmod)


def test_osnet_train_matches_jax(osnet_run):
    """``OSNetReId.train``: 5 steps an epoch (44 crops, 11 identities)."""
    _check_run(osnet_run, 2, 10)
    jmod, tmod = osnet_run["jmod"], osnet_run["tmod"]
    assert tmod._model is None and tmod._trained is not None
    assert not tmod._trained.training
    want = _osnet_view(jmod.variables["params"],
                       jmod.variables["batch_stats"])
    _close_stats(tmod._trained.state_dict(),
                 {k: v for k, v in want.items() if "running" in k}, "BN")
    # the next process embeds with the trained OSNet
    crops = np.random.default_rng(0).uniform(0, 255, (3,) + CROP + (3,)) \
        .astype(np.float32)
    got = tmod.process({"crop": crops}, pd.DataFrame(index=[4, 5, 6]), None)
    assert tmod._model is tmod._trained
    assert np.isfinite(np.stack(got["embeddings"].to_numpy())).all()


def test_zoo_backbone_after_train_raises_in_both(tree):
    """JAX's ``train_reid`` trains an OSNet whatever ``backbone=`` says and
    stores its variables on the module, whose zoo model then cannot apply
    them: the next ``process`` raises in both packages (no step is taken
    here: epochs=0)."""
    kw = dict(backbone="resnet18", feat_dim=32, crop_size=CROP)
    jmod, tmod = JOSNetReId(**kw), OSNetReId(device="cpu", **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Module, "init", _numpy_init(5, {}))
        jmod.train(tree, None, None, None, epochs=0)
    tmod.train(tree, epochs=0)
    crops = np.zeros((2,) + CROP + (3,), np.float32)
    rows = pd.DataFrame(index=[0, 1])
    with pytest.raises(Exception):
        jmod.process({"crop": crops}, rows, None)
    with pytest.raises(ValueError, match="train"):
        tmod.process({"crop": crops}, rows, None)


KPR_ARCH = dict(crop_size=CROP, num_parts=3, dim_reduce_output=16,
                embed_dim=32, depth=2, num_heads=2, patch_size=16, stride=16)


def _kpr_view(params, stats):
    tree = {"params": params}
    bs = stats.get("kpr", stats)
    if bs:
        tree["batch_stats"] = bs
    return kpr_from_flax(tree)


@pytest.fixture(scope="module")
def kpr_run(tree):
    jmod = JKPReId(use_keypoints=False, **KPR_ARCH)
    tmod = KPReId(use_keypoints=False, device="cpu", **KPR_ARCH)
    arch = {k: v for k, v in tmod.arch.items()}

    def model_of(params, stats):
        model = KPR(n_prompt_ch=7, device="cpu", **arch)
        model.load_state_dict(_kpr_view(params, stats), strict=True)
        return model

    run = _run_both(jmod, tmod, tree, _kpr_view, "id_head", model_of,
                    epochs=2, batch=16)
    return dict(run, jmod=jmod, tmod=tmod)


def test_kpr_train_matches_jax(kpr_run):
    """``KPReId.train`` on a depth-2 ViT (attention through
    ``VitAttentionFn``): 2 steps an epoch; the BatchNorms' statistics
    (momentum 0.9) after the run."""
    _check_run(kpr_run, 2, 4)
    jmod, tmod = kpr_run["jmod"], kpr_run["tmod"]
    assert tmod._model is None and not tmod._trained.training
    want = kpr_from_flax(jmod.variables)
    _close_stats(tmod._trained.state_dict(),
                 {k: v for k, v in want.items() if "running" in k}, "BN")


def test_cli_train_tracking_trains_kpr_then_tracks(tmp_path):
    """``train_tracking=true`` with GT detections -> a tiny KPReId ->
    BPBReID-StrongSORT on the port's command line: the ReID trains (one
    epoch, asked by a spy), its weights move, then the run tracks with the
    trained model and is evaluated."""
    seen = {}
    real = KPReId.train

    def spy(self, *a, **kw):
        self._build()
        seen["before"] = {k: v.clone()
                          for k, v in self._model.state_dict().items()}
        out = real(self, *a, **dict(kw, epochs=1))
        seen["loss"] = out["loss"]
        seen["module"] = self
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(KPReId, "train", spy)
        parts, results = TM.main([
            "device=cpu", "train_tracking=true", "use_rich=false",
            "pipeline=[reid,track]", "+modules/reid=kpr",
            "modules.reid.use_keypoints=false",
            "modules.reid.crop_size=[32,16]", "+modules.reid.depth=1",
            "+modules.reid.embed_dim=32", "+modules.reid.num_heads=2",
            "modules.reid.dim_reduce_output=16",
            "+modules.reid.patch_size=8", "+modules.reid.stride=8",
            "modules/track=bpbreid_strong_sort",
            "modules.track.embed_dim=16", "modules.track.max_dets=8",
            "modules.track.max_tracks=16", "modules.track.n_init=1",
            "modules.track.max_dist=0.6", "modules.track.max_iou_distance=0.9",
            "dataset.n_videos=1",
            "dataset.n_frames=6", "dataset.n_objects=3",
            "dataset.img_w=64", "dataset.img_h=64",
            "state.load_from_groundtruth={detection: "
            "[bbox_ltwh, bbox_conf, category_id]}"])
    mod = seen["module"]
    assert mod._model is mod._trained
    assert len(seen["loss"]) == 1 and np.isfinite(seen["loss"]).all()
    assert any(not torch.equal(seen["before"][k], v)
               for k, v in mod._model.state_dict().items())
    assert parts["tracker_state"].detections_pred["track_id"].notna().any()
    assert results is not None
