"""The port's pose models against the JAX package's on the CPU.

YOLOXPose-nano at 128 x 128 (head maps, decoded boxes and keypoints),
TopDownPose-nano and SimCCPose-nano on 64 x 48 crops (heatmaps, the SimCC
bin vectors and keypoints), the flax ``nn.ConvTranspose`` (SAME, stride 2,
k 4) against torch's ``ConvTranspose2d(k=4, s=2, p=1)`` with the flipped
kernel, ``decode_heatmaps`` and ``decode_simcc`` on tie-laden maps,
YOLO11n-Pose at 128 x 128 (``decode_v11_kpts``) and ViTPose-tiny with both
decoders, each through its ``*_from_flax`` converter; and
``convert_vitpose_torch`` on the port's own state dict. Maps within 1e-5 of
each map's scale, keypoints within 1e-3 px.

The flax variables are seeded numpy draws on the trees' shapes (no init
program is compiled): He-normal kernels, BN scales and variances in
[0.5, 1.5], biases and means N(0, 0.1), so every parameter shows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracklab_tpu.models import pose as JP
from tracklab_tpu.models import vitpose as JV
from tracklab_tpu.models import yolo11 as JY
from tracklab_torch.models import convert as TC
from tracklab_torch.models import pose as TP
from tracklab_torch.models import vitpose as TV
from tracklab_torch.models import yolo11 as TY

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)


def _variables(jmodel, shape, seed, head=None):
    """Seeded flax variables of ``jmodel`` at an input of ``shape``. The
    prediction convs whose path matches the regex ``head`` are drawn at std
    0.01 (as detection heads are initialised), so that decoded boxes and
    keypoints stay within the input and heatmaps off sigmoid's saturation:
    the px bounds then test the decode, not f32's resolution at 10^4 px."""
    import re

    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros(shape, jnp.float32))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        where = "/".join(str(p.key) for p in path)
        if head and re.search(head, where) and name == "kernel":
            return rng.normal(0, 0.01, a.shape).astype(np.float32)
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            return rng.normal(0, np.sqrt(2.0 / fan_in), a.shape).astype(
                np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "position_embeddings":
            return rng.normal(0, 0.02, a.shape).astype(np.float32)
        return rng.normal(0, 0.1, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _close_maps(got, want):
    """Within 1e-5 of the map's scale (f32 convolutions summed in another
    order)."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _close_kps(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)


def _heatmap_keypoints(hm, crop_h):
    """JAX's ``predict_keypoints`` of a heatmap model on its maps:
    ``decode_heatmaps`` of the sigmoid, scaled by the crop's stride."""
    kp = JP.decode_heatmaps(jax.nn.sigmoid(hm))
    return kp.at[..., :2].multiply(crop_h / hm.shape[1])


def _pixels(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def test_yoloxpose_maps_boxes_and_keypoints_match_jax():
    jm = JP.YOLOXPose(num_classes=1, num_keypoints=17, variant="nano")
    # [0, 1] pixels: the He-normal draw keeps the input's scale, and at
    # 0-255 the wh logits would sit at exp()'s clamp
    x = _pixels((2, 128, 128, 3), 2)
    v = _variables(jm, (1, 128, 128, 3), seed=1, head=r"^params/Conv_")
    want_maps, (want_boxes, want_kps) = jax.jit(
        lambda v, x: (jm.apply(v, x), jm.predict(v, x)))(v, x)
    model = TP.YOLOXPose(num_classes=1, num_keypoints=17, variant="nano",
                         device="cpu")
    model.load_state_dict(TC.yoloxpose_from_flax(v), strict=True)
    with torch.no_grad():
        got_maps = model(torch.from_numpy(x))
    # [reg 4, obj 1, cls 1, kp 17 x 3] per level, K3's layer sizes
    assert [tuple(m.shape) for m in got_maps] == [
        (2, 16, 16, 57), (2, 8, 8, 57), (2, 4, 4, 57)]
    for g, w in zip(got_maps, want_maps):
        _close_maps(g, w)
    boxes, kps = model.predict(torch.from_numpy(x))
    # the repo's box bounds (tests/test_fused_engine.py): exp() of the wh
    # logits carries the maps' 1e-5 to a few 1e-5 of each side
    np.testing.assert_allclose(boxes.numpy(), np.asarray(want_boxes),
                               rtol=1e-4, atol=1e-3)
    _close_kps(kps, want_kps)


def test_conv_transpose_equivalence():
    """flax ``nn.ConvTranspose(k=4, strides=2, padding="SAME")`` (the
    kernel applied without a flip; lax pads the dilated input by 2 / 2)
    equals torch's ``conv_transpose2d(stride=2, padding=1)`` with the kernel
    flipped and laid out (in, out, kh, kw), ``_deconv_weight``; so does the
    input-dilated conv of the JAX package's ViTPose."""
    import flax.linen as nn

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 7, 6)).astype(np.float32)
    k = rng.normal(size=(4, 4, 6, 3)).astype(np.float32)
    ct = nn.ConvTranspose(3, (4, 4), strides=(2, 2), padding="SAME",
                          use_bias=False)
    want = ct.apply({"params": {"kernel": k}}, x)
    dil = nn.Conv(3, (4, 4), strides=1, input_dilation=2,
                  padding=[(2, 2), (2, 2)], use_bias=False)
    want_dil = dil.apply({"params": {"kernel": k}}, x)
    w = torch.from_numpy(np.ascontiguousarray(TC._deconv_weight(k)))
    got = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), w, None, 2, 1)
    got = got.permute(0, 2, 3, 1)
    assert got.shape == (2, 10, 14, 3)
    for ref in (want, want_dil):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5)


def test_decoders_on_ties_match_jax():
    """``decode_heatmaps`` and ``decode_simcc`` on maps with repeated maxima
    and flat neighbourhoods (first-index argmax, sign(0) = 0, the border
    clamp), equal to JAX's bit for bit."""
    rng = np.random.default_rng(3)
    hm = rng.integers(0, 4, (3, 6, 5, 7)).astype(np.float32) / 4
    hm[0, :, :, 0] = 1.0                      # all tied: index 0, no step
    hm[1, 5, 4, 1] = 2.0                      # peak at the far corner
    got = TP.decode_heatmaps(torch.from_numpy(hm))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.jit(JP.decode_heatmaps)(hm)))
    sx = rng.integers(-2, 3, (2, 7, 24)).astype(np.float32)
    sy = rng.integers(-2, 3, (2, 7, 32)).astype(np.float32)
    sx[0, 0] = -1.0                           # score <= 0: locations -1
    got = TP.decode_simcc(torch.from_numpy(sx), torch.from_numpy(sy), 2.0)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.jit(JP.decode_simcc)(sx, sy)))


def test_topdown_and_simcc_match_jax():
    x = _pixels((3, 64, 48, 3), 4)
    jm = JP.TopDownPose(num_keypoints=17, variant="nano")
    v = _variables(jm, (1, 64, 48, 3), seed=5, head=r"^params/Conv_")
    want_hm, want_kp = jax.jit(lambda v, x: (lambda o: (
        o, _heatmap_keypoints(o, 64)))(jm.apply(v, x)))(v, x)
    model = TP.TopDownPose(num_keypoints=17, variant="nano", device="cpu")
    model.load_state_dict(TC.topdownpose_from_flax(v), strict=True)
    with torch.no_grad():
        hm = model(torch.from_numpy(x))
    # the /32 map of a 64 x 48 crop is 2 x 2 (3 rounds up), so 16 x 16
    assert hm.shape == (3, 16, 16, 17)
    _close_maps(hm, want_hm)
    _close_kps(model.predict_keypoints(torch.from_numpy(x)), want_kp)

    js = JP.SimCCPose(num_keypoints=17, variant="nano", input_size=(64, 48))
    v = _variables(js, (1, 64, 48, 3), seed=6, head=r"mlp_")
    (want_x, want_y), want_kp = jax.jit(lambda v, x: (lambda o: (
        o, JP.decode_simcc(*o, 2.0)))(js.apply(v, x)))(v, x)
    model = TP.SimCCPose(num_keypoints=17, variant="nano",
                         input_size=(64, 48), device="cpu")
    model.load_state_dict(TC.simccpose_from_flax(v), strict=True)
    with torch.no_grad():
        gx, gy = model(torch.from_numpy(x))
    _close_maps(gx, want_x)
    _close_maps(gy, want_y)
    _close_kps(model.predict_keypoints(torch.from_numpy(x)), want_kp)


def test_yolo11_pose_matches_jax():
    jm = JY.YOLO11Pose(num_classes=1, num_keypoints=17, variant="n")
    x = _pixels((2, 128, 128, 3), 7)
    v = _variables(jm, (1, 128, 128, 3), seed=8,
                   head=r"model__23__cv\d__\d__2/")
    # one traced forward: YOLO11Pose.predict is JAX's decode_v8 and
    # decode_v11_kpts of the two map lists
    (want_det, want_kpt), (want_boxes, want_kps) = jax.jit(
        lambda v, x: (lambda o: (o, (JY.decode_v8(o[0], 1, 16),
                                     JY.decode_v11_kpts(o[1], 17))))(
            jm.apply(v, x)))(v, x)
    model = TY.YOLO11Pose(num_classes=1, num_keypoints=17, variant="n",
                          device="cpu")
    model.load_state_dict(TC.yolo11_from_flax(v), strict=True)
    with torch.no_grad():
        det, kpt = model(torch.from_numpy(x))
    assert [tuple(k.shape) for k in kpt] == [(2, 16, 16, 51), (2, 8, 8, 51),
                                             (2, 4, 4, 51)]
    for g, w in zip(det + kpt, list(want_det) + list(want_kpt)):
        _close_maps(g, w)
    boxes, kps = model.predict(torch.from_numpy(x))
    np.testing.assert_allclose(boxes.numpy(), np.asarray(want_boxes),
                               rtol=1e-4, atol=2e-3)
    _close_kps(kps, want_kps)
    np.testing.assert_allclose(
        TY.decode_v11_kpts(kpt, 17).numpy(),
        np.asarray(JY.decode_v11_kpts([np.asarray(k) for k in want_kpt],
                                      17)), rtol=0, atol=1e-3)


@pytest.mark.parametrize("simple", [False, True], ids=["classic", "simple"])
def test_vitpose_matches_jax(simple):
    x = _pixels((2, 64, 48, 3), 9)
    jm = JV.ViTPose(num_keypoints=17, variant="tiny", simple_decoder=simple)
    v = _variables(jm, (1, 64, 48, 3), seed=10, head=r"head/conv/")
    want_hm, want_kp = jax.jit(lambda v, x: (lambda o: (
        o, _heatmap_keypoints(o, 64)))(jm.apply(v, x)))(v, x)
    model = TV.ViTPose(num_keypoints=17, variant="tiny", simple_decoder=simple,
                       input_size=(64, 48), device="cpu")
    model.load_state_dict(TC.vitpose_from_flax(v), strict=True)
    with torch.no_grad():
        hm = model(torch.from_numpy(x))
    assert hm.shape == (2, 16, 12, 17)
    _close_maps(hm, want_hm)
    _close_kps(model.predict_keypoints(torch.from_numpy(x)), want_kp)


def test_convert_vitpose_torch_loads_hf_names():
    """An HF-named state dict (the port's own keys, with BN's
    num_batches_tracked, in half precision) loads into a fresh model; a
    missing tensor raises."""
    src = TV.ViTPose(num_keypoints=5, variant="tiny", input_size=(64, 48),
                     device="cpu").randomize_(3)
    sd = src.state_dict()
    hf = {k: v.half() for k, v in sd.items()}
    hf["head.batchnorm1.num_batches_tracked"] = torch.tensor(3)
    assert "backbone.encoder.layer.0.attention.attention.query.weight" in hf
    got = TC.convert_vitpose_torch(hf, TV.ViTPose(
        num_keypoints=5, variant="tiny", input_size=(64, 48), device="cpu"))
    for k, v in got.state_dict().items():
        torch.testing.assert_close(v, sd[k].half().float(), rtol=0, atol=0)
    del hf["head.conv.bias"]
    with pytest.raises(ValueError, match="missing"):
        TC.convert_vitpose_torch(hf, TV.ViTPose(
            num_keypoints=5, variant="tiny", input_size=(64, 48),
            device="cpu"))
