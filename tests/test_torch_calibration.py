"""The port's calibration against the JAX package's on the CPU: the pitch
template, the priors and the one-cycle schedule, ``project_points`` and
``backproject_to_pitch``, TVCalib's ``_frame_loss`` and its gradient
against ``jax.grad``, ``optimize_cameras`` at 30 steps, ``PitchSegNet`` and
``extract_segment_points`` (equal indices), the wrappers
``PitchLineDetector``, ``TVCalibration`` and ``PitchProjection`` on the
same rows, and DeepLabV3 (cut to one bottleneck per layer): its logits,
``convert_deeplabv3_torch`` on torchvision keys and
``PitchLineDetector(variant="deeplabv3")``.

Observations are the synthetic game-state camera's pitch lines (the JAX
package's ``_gs_camera`` / ``_gs_pitch_lines``) at 640 x 360.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from tracklab_tpu.calibration import camera as JC
from tracklab_tpu.calibration import tvcalib as JT
from tracklab_tpu.calibration.cam_distr import priors_array as jpriors
from tracklab_tpu.calibration.pitch import pitch_segments as jsegments
from tracklab_tpu.models.convert import (_generic_torch_key,
                                         export_torch_state_dict)
from tracklab_tpu.models.deeplabv3 import DeepLabV3 as JDeepLabV3
from tracklab_tpu.models.segmentation import PitchSegNet as JPitchSegNet
from tracklab_tpu.models.segmentation import \
    extract_segment_points as jextract
from tracklab_tpu.wrappers import calibration_api as JAPI
from tracklab_tpu.wrappers.dataset.synthetic import (_gs_camera,
                                                     _gs_pitch_lines)
from tracklab_torch.calibration import camera as TC
from tracklab_torch.calibration import tvcalib as TT
from tracklab_torch.calibration.cam_distr import priors_array
from tracklab_torch.calibration.pitch import pitch_segments
from tracklab_torch.models.convert import (convert_deeplabv3_torch,
                                           deeplabv3_from_flax,
                                           pitchsegnet_from_flax)
from tracklab_torch.models.deeplabv3 import DeepLabV3
from tracklab_torch.models.segmentation import (PitchSegNet,
                                                extract_segment_points)
from tracklab_torch.wrappers import calibration_api as TAPI

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

W, H = 640, 360


def _observations(n_frames=4, seed=0):
    rng = np.random.default_rng(seed)
    return [_gs_pitch_lines(_gs_camera(W, H, pan=0.05 * v), W, H, rng)
            for v in range(n_frames)]


def _jcam(vals):
    pan, tilt, roll, focal, x, y, z, k1, k2 = vals
    return JC.CameraParams(
        pan=jnp.float32(pan), tilt=jnp.float32(tilt), roll=jnp.float32(roll),
        focal=jnp.float32(focal), position=jnp.asarray([x, y, z],
                                                       jnp.float32),
        principal=jnp.asarray([W / 2, H / 2], jnp.float32),
        distortion=jnp.asarray([k1, k2], jnp.float32))


def _tcam(vals):
    pan, tilt, roll, focal, x, y, z, k1, k2 = vals

    def t(v):
        return torch.tensor(v, dtype=torch.float32)
    return TC.CameraParams(pan=t(pan), tilt=t(tilt), roll=t(roll),
                           focal=t(focal), position=t([x, y, z]),
                           principal=t([W / 2, H / 2]),
                           distortion=t([k1, k2]))


CAMERAS = [(0.0, 1.25, 0.01, 366.7, 0.0, 55.0, 18.0, 0.0, 0.0),
           (0.3, 1.1, -0.05, 500.0, -20.0, 60.0, 25.0, 0.1, -0.02),
           (-0.6, 1.4, 0.1, 800.0, 30.0, 70.0, 12.0, -0.2, 0.05)]


def test_template_priors_and_schedule_match_jax():
    got, want = pitch_segments(), jsegments()
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for kw in ({}, dict(camera_types=("main_left", "main_behind"),
                        sigma_scale=1.65, lens_distortion=False)):
        np.testing.assert_array_equal(priors_array(**kw), jpriors(**kw))
    for steps, peak, pct in ((300, 0.05, 0.5), (30, 1e-3, 0.33)):
        want = optax.cosine_onecycle_schedule(steps, peak, pct_start=pct)
        np.testing.assert_allclose(
            TT.onecycle_lrs(steps, peak, pct),
            [float(want(jnp.int32(t))) for t in range(steps)], rtol=1e-6)


@pytest.mark.parametrize("cam", range(len(CAMERAS)))
def test_projection_and_backprojection_match_jax(cam):
    vals = CAMERAS[cam]
    pts = np.concatenate(list(jsegments().values())).astype(np.float32)
    pj, fj = JC.project_points(_jcam(vals), jnp.asarray(pts))
    pt, ft = TC.project_points(_tcam(vals), torch.from_numpy(pts))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    # pixels near 1e3 in f32: 1e-3 px is ~16 ulps
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=1e-3)
    pix = np.random.default_rng(cam).uniform([0, H / 2], [W, H],
                                             (50, 2)).astype(np.float32)
    wj = JC.backproject_to_pitch(_jcam(vals), jnp.asarray(pix))
    wt = TC.backproject_to_pitch(_tcam(vals), torch.from_numpy(pix))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(TC.camera_matrix(_tcam(vals)).numpy(),
                               np.asarray(JC.camera_matrix(_jcam(vals))),
                               rtol=1e-5, atol=1e-3)


def test_frame_loss_and_gradient_match_jax():
    """The loss and ``jax.grad`` of it at the zero latent and three random
    ones, for each of 3 frames: the loss within 1e-6 relative, the
    gradient within 1e-6 of its own scale (torch.amin spreads a min's
    gradient over ties as jnp.min does)."""
    cfg = JT.TVCalibConfig(image_width=W, image_height=H)
    tcfg = TT.TVCalibConfig(image_width=W, image_height=H)
    names, template = JT._build_template(cfg)
    template = template.astype(jnp.float32)   # the suite enables x64
    pts, seg, valid = JT._pack_observations(_observations(3), names, cfg)
    pri = jpriors(("main_center",), 1.96, lens_distortion=True)[0]
    zs = np.random.default_rng(1).normal(0, 0.5, (4, 9)).astype(np.float32)
    zs[0] = 0
    loss_grad = jax.jit(jax.value_and_grad(JT._frame_loss),
                        static_argnums=(6,))
    for z in zs:
        for b in range(3):
            lj, gj = loss_grad(jnp.asarray(z), pts[b], seg[b], valid[b],
                               jnp.asarray(pri), template, cfg)
            zt = torch.tensor(z, requires_grad=True)
            lt = TT._frame_loss(zt, torch.from_numpy(pts[b]),
                                torch.from_numpy(seg[b]),
                                torch.from_numpy(valid[b]),
                                torch.from_numpy(pri),
                                torch.from_numpy(np.array(template)), tcfg)
            gt, = torch.autograd.grad(lt, zt)
            np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
            gj = np.asarray(gj)
            np.testing.assert_allclose(gt.numpy(), gj, rtol=0,
                                       atol=1e-6 * np.abs(gj).max())


# optimize_cameras over 30 steps: hypotheses exactly; the final NDC errors
# within 1e-2 relative, pan within 0.3 degree, tilt 0.05, roll 0.6, focal
# 0.5 px, the position within 0.4 m and the latents within 0.06. The
# descent amplifies rounding: AdamW moves every latent by about its
# learning rate whatever its gradient's size, so along the loss's flat
# valleys the rounding steers it. On these frames a change of 1e-4 px in
# the observations (their noise is 0.5 px) moves the port's own cameras on
# the CPU by up to 0.14 degree of pan, 0.007 of tilt, 0.32 of roll,
# 0.14 px of focal, 0.21 m and 3.1e-3 of the error, and 0.028 in the
# latents (ten draws); the bounds are twice that. (The port descends in
# f32, JAX here in f64: the suite enables x64.) chip_smoke's phase
# baseline measures the same spread on the card and holds the card to
# these bounds on this case.
TOL = dict(pan_degrees=0.3, tilt_degrees=0.05, roll_degrees=0.6,
           x_focal_length=0.5, y_focal_length=0.5)


def _assert_cameras_close(got, want):
    assert got["camera_type"] == want["camera_type"]
    for k, tol in TOL.items():
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])
    np.testing.assert_allclose(got["position_meters"],
                               want["position_meters"], rtol=0, atol=0.4)
    np.testing.assert_allclose(got["radial_distortion"],
                               want["radial_distortion"], rtol=0, atol=1e-4)
    assert got["principal_point"] == want["principal_point"]
    for ct, v in want["hypothesis_losses"].items():
        np.testing.assert_allclose(got["hypothesis_losses"][ct], v,
                                   rtol=1e-2)


def test_optimize_cameras_matches_jax():
    obs = _observations(4)
    kw = dict(steps=30, image_width=W, image_height=H,
              camera_types=("main_center", "main_left", "main_behind"))
    want, jerr = JT.optimize_cameras(obs, JT.TVCalibConfig(**kw))
    got, err = TT.optimize_cameras(obs, TT.TVCalibConfig(**kw),
                                   device="cpu")
    assert [c["camera_type"] for c in got] == [c["camera_type"]
                                               for c in want]
    np.testing.assert_allclose(err, jerr, rtol=1e-2)
    for g, w in zip(got, want):
        _assert_cameras_close(g, w)
        np.testing.assert_allclose(g["latent"], w["latent"], rtol=0,
                                   atol=0.06)
    # a warm start (B, 9) broadcast over the hypotheses
    z0 = np.stack([c["latent"] for c in want])
    want, _ = JT.optimize_cameras(obs, JT.TVCalibConfig(**kw),
                                  init_latents=z0)
    got, _ = TT.optimize_cameras(obs, TT.TVCalibConfig(**kw),
                                 init_latents=z0, device="cpu")
    for g, w in zip(got, want):
        _assert_cameras_close(g, w)


def _seg_variables(jmodel, shape, seed=0):
    """Seeded PitchSegNet variables on the flax tree's shapes: He-normal
    kernels, BN scales and variances in [0.5, 1.5], biases and means
    N(0, 0.1)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + shape + (3,)))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            return rng.normal(0, np.sqrt(2.0 / fan_in), a.shape).astype(
                np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return rng.normal(0, 0.1, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def segnet(tmp_path_factory):
    """PitchSegNet-nano at 64 x 128 with seeded variables, as JAX's model
    and the port's (through ``pitchsegnet_from_flax``, also saved as a
    checkpoint)."""
    jmodel = JPitchSegNet(num_classes=21, variant="nano")
    variables = _seg_variables(jmodel, (64, 128))
    ckpt = tmp_path_factory.mktemp("seg") / "pitchseg.pt"
    torch.save(pitchsegnet_from_flax(variables), ckpt)
    model = PitchSegNet(21, "nano", device="cpu")
    model.load_state_dict(torch.load(ckpt, weights_only=True), strict=True)
    images = np.random.default_rng(3).integers(0, 256, (2, 64, 128, 3))
    return jmodel, variables, model, ckpt, images.astype(np.uint8)


def test_pitchsegnet_matches_jax(segnet):
    jmodel, variables, model, _, images = segnet
    x = images.astype(np.float32)
    # one compile instead of an eager dispatch per flax op
    want = np.asarray(jax.jit(jmodel.apply)(variables, x))
    with torch.no_grad():
        got = model(torch.from_numpy(images)).numpy()
    assert got.shape == (2, 64, 128, 21)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(model.predict(torch.from_numpy(images)),
                                  np.argmax(want, -1))


@pytest.mark.parametrize("shape,n_classes", [((64, 128), 21),
                                             ((288, 512), 21),
                                             ((7, 9), 4)],
                         ids=["64x128", "288x512", "7x9"])
def test_extract_segment_points_equals_jax(shape, n_classes):
    """The same points in the same order. At 288 x 512 the 20-bit hash
    collides (equal scores), which ``lax.top_k`` breaks by the lower index;
    a 7 x 9 map with 32 points per class keeps invalid ones."""
    rng = np.random.default_rng(sum(shape))
    cmap = rng.integers(0, n_classes, (2,) + shape).astype(np.int32)
    cmap[1, :, : shape[1] // 2] = 0          # background-heavy frame
    xj, vj = jax.vmap(lambda m: jextract(m, n_classes, 32))(
        jnp.asarray(cmap))
    xt, vt = extract_segment_points(torch.from_numpy(cmap), n_classes, 32)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert not np.asarray(vj).all() or shape != (7, 9)


def test_pitch_line_detector_matches_jax(segnet):
    """Both packages' wrappers on the same resized batch: the same
    segments and points; the port's host resize is within one grey level
    of cv2's."""
    _, variables, _, ckpt, images = segnet
    jdet = JAPI.PitchLineDetector(variant="nano", input_size=(64, 128))
    jdet._variables = variables
    tdet = TAPI.PitchLineDetector(variant="nano", input_size=(64, 128),
                                  checkpoint_path=str(ckpt), device="cpu")
    meta = pd.DataFrame(index=[10, 11])
    batch = {"image": images.astype(np.float32),
             "scale": np.array([[3.0, 3.0]] * 2, np.float32)}
    _, want = jdet.process(batch, None, meta)
    _, got = tdet.process(dict(batch, image=images), None, meta)
    for g, w in zip(got, want):
        assert g.name == w.name
        assert list(g["pitch_lines"]) == list(w["pitch_lines"])
        for k, v in w["pitch_lines"].items():
            np.testing.assert_array_equal(g["pitch_lines"][k], v)
    frame = np.random.default_rng(4).integers(0, 256, (192, 384, 3),
                                              dtype=np.uint8)
    g = tdet.preprocess(frame, None, None)
    w = jdet.preprocess(frame, None, None)
    np.testing.assert_array_equal(g["scale"], w["scale"])
    assert np.abs(g["image"].astype(int) - w["image"].astype(int)).max() <= 1


# ------------------------------------------------------------ DeepLabV3
DEEPLAB_LAYERS = (1, 1, 1, 1)     # ResNet-101's (3, 4, 23, 3), cut


@pytest.fixture(scope="module")
def deeplab(tmp_path_factory):
    """DeepLabV3 with one bottleneck per ResNet layer at 64 x 128: JAX's
    model with seeded variables, the port's through
    ``deeplabv3_from_flax`` (also saved as a checkpoint)."""
    jmodel = JDeepLabV3(layers=DEEPLAB_LAYERS)
    variables = _seg_variables(jmodel, (64, 128), seed=1)
    model = DeepLabV3(layers=DEEPLAB_LAYERS, device="cpu")
    model.load_state_dict(deeplabv3_from_flax(variables), strict=True)
    ckpt = tmp_path_factory.mktemp("deeplab") / "deeplabv3.pt"
    torch.save(model.state_dict(), ckpt)
    return jmodel, variables, model, ckpt


def test_deeplabv3_matches_jax(deeplab):
    """``out`` and ``aux`` logits within 1e-4 of their scale; the argmax
    equal wherever the top two classes are 1e-5 apart or more."""
    jmodel, variables, model, _ = deeplab
    x = np.random.default_rng(5).normal(0, 1, (2, 64, 128, 3)).astype(
        np.float32)
    want = jax.jit(jmodel.apply)(variables, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for k in ("out", "aux"):
        w = np.asarray(want[k])
        assert got[k].shape == w.shape == (2, 64, 128, 29)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
    w = np.asarray(want["out"])
    top2 = np.sort(w, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] >= 1e-5
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(
        model.predict(torch.from_numpy(x)).numpy()[clear],
        np.argmax(w, -1)[clear])


def test_convert_deeplabv3_torch_loads_torchvision_keys(deeplab):
    """The torchvision-named dict JAX's exporter writes, held under
    ``model`` with ``module.`` prefixes and BN's ``num_batches_tracked``
    as a training checkpoint holds it, loads equal to
    ``deeplabv3_from_flax``'s; a model without ``aux`` leaves the aux head's
    tensors unread; a missing tensor raises."""
    jmodel, variables, model, _ = deeplab
    sd = export_torch_state_dict(jmodel, variables, _generic_torch_key)
    sd["backbone.bn1.num_batches_tracked"] = np.int64(2)
    ckpt = {"model": {f"module.{k}": v for k, v in sd.items()}}
    got = convert_deeplabv3_torch(ckpt, DeepLabV3(layers=DEEPLAB_LAYERS,
                                                  device="cpu"))
    want = model.state_dict()
    for k, v in got.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    no_aux = convert_deeplabv3_torch(sd, DeepLabV3(
        layers=DEEPLAB_LAYERS, aux=False, device="cpu"))
    assert not any(k.startswith("aux_") for k in no_aux.state_dict())
    del sd["classifier.0.convs.4.2.running_mean"]
    with pytest.raises(ValueError, match="missing"):
        convert_deeplabv3_torch(sd, DeepLabV3(layers=DEEPLAB_LAYERS,
                                              device="cpu"))


def test_pitch_line_detector_deeplabv3_matches_jax(deeplab, monkeypatch):
    """``PitchLineDetector(variant="deeplabv3")`` in both packages (the
    model cut to DEEPLAB_LAYERS in both) on the same resized batch: the
    same LUT, segments and points."""
    import tracklab_tpu.models.deeplabv3 as JD
    import tracklab_torch.models.deeplabv3 as TD

    _, variables, _, ckpt = deeplab
    np.testing.assert_array_equal(
        TD.segment_class_lut(pitch_segments()).numpy(),
        np.asarray(JD.segment_class_lut(jsegments())))
    for mod, cls in ((JD, JDeepLabV3), (TD, DeepLabV3)):
        monkeypatch.setattr(mod, "DeepLabV3",
                            functools.partial(cls, layers=DEEPLAB_LAYERS))
    jdet = JAPI.PitchLineDetector(variant="deeplabv3", input_size=(64, 128))
    jdet._variables = variables
    tdet = TAPI.PitchLineDetector(variant="deeplabv3", input_size=(64, 128),
                                  checkpoint_path=str(ckpt), device="cpu")
    images = np.random.default_rng(7).integers(0, 256, (2, 64, 128, 3),
                                               dtype=np.uint8)
    meta = pd.DataFrame(index=[20, 21])
    batch = {"image": images.astype(np.float32),
             "scale": np.array([[3.0, 3.0]] * 2, np.float32)}
    _, want = jdet.process(batch, None, meta)
    _, got = tdet.process(dict(batch, image=images), None, meta)
    assert sum(len(w["pitch_lines"]) for w in want) >= 4
    for g, w in zip(got, want):
        assert g.name == w.name
        assert list(g["pitch_lines"]) == list(w["pitch_lines"])
        for k, v in w["pitch_lines"].items():
            np.testing.assert_array_equal(g["pitch_lines"][k], v)


def test_tvcalibration_and_projection_match_jax():
    """TVCalibration (30 steps) on three frames with pitch lines and one
    without (whose dataset camera passes through), then PitchProjection of
    boxes with each package's parameters."""
    obs = _observations(3) + [{}]
    meta = pd.DataFrame({"video_id": 0, "pitch_lines": obs,
                         "parameters": [None] * 3 + [{
                             "pan_degrees": 2.0, "tilt_degrees": 72.0,
                             "roll_degrees": 0.5, "x_focal_length": 400.0,
                             "position_meters": [0.0, 50.0, 15.0]}]},
                        index=[5, 6, 7, 8])
    kw = dict(steps=30, image_width=W, image_height=H)
    jcal = JAPI.TVCalibration(**kw)
    tcal = TAPI.TVCalibration(**kw, device="cpu")
    batch = {"pitch_lines": list(meta["pitch_lines"])}
    _, want = jcal.process(batch, None, meta)
    _, got = tcal.process(batch, None, meta)
    assert [r.name for r in got] == [r.name for r in want] == [5, 6, 7, 8]
    for g, w in zip(got, want):
        g, w = g["parameters"], w["parameters"]
        assert sorted(g) == sorted(w)
        if "camera" in w:
            _assert_cameras_close(g, w)
            np.testing.assert_allclose(g["relative_mean_reproj"],
                                       w["relative_mean_reproj"], rtol=1e-2)
        else:
            assert g == w
    rng = np.random.default_rng(6)
    dets = pd.DataFrame({
        "image_id": np.repeat([5, 6, 7, 8], 3),
        "bbox_ltwh": list(np.column_stack([
            rng.uniform(0, W - 40, 12), rng.uniform(H / 3, H - 80, 12),
            rng.uniform(10, 40, 12), rng.uniform(20, 80, 12)]))},
        index=np.arange(100, 112))
    params = pd.DataFrame({"parameters": [r["parameters"] for r in want]},
                          index=meta.index)
    pw = JAPI.PitchProjection(image_width=W, image_height=H).process(
        dets, params)
    pg = TAPI.PitchProjection(image_width=W, image_height=H,
                              device="cpu").process(dets, params)
    pd.testing.assert_index_equal(pg.index, pw.index)
    for g, w in zip(pg["bbox_pitch"], pw["bbox_pitch"]):
        assert list(g) == list(w)
        np.testing.assert_allclose(list(g.values()), list(w.values()),
                                   rtol=1e-5, atol=1e-3)
