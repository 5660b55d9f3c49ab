"""The port's int8 post-training quantization (``models/quantize.py``)
against the JAX package's on the CPU.

* ``quant_conv_int8`` at the detectors' convolution shapes: the codes, the
  weight scales, the int32 accumulators of the plain version and the
  dequantized output equal JAX's exactly, on integer-valued inputs (where
  int8 is lossless; tests/test_quantize.py's case) and on random ones;
* YOLOX-nano, YOLOv8n and YOLO11n at 64 x 64 with JAX's weights carried
  across: ``quant="calib"`` visits JAX's ``qstats`` paths, the calibrated
  scales are within 2e-6 relative of JAX's, and with JAX's scales carried
  across (``quant_from_flax``) the int8 model's input codes at every
  quantized convolution and its decoded predictions match JAX's int8
  model's;
* ``YOLOXDetector`` and ``YOLOv8Detector`` with ``quant="int8"``
  calibrate on the first batch, within 2e-6 of JAX's wrappers' scales, and
  with JAX's scales give JAX's wrappers' rows;
* no CSPLayer of a calib or int8 model takes K3, as JAX's
  ``csp_pallas_supported`` admits none; ``quant="int8"`` on RTMDet and the
  lightweight RT-DETR fails in both packages, the port at construction.

Each JAX model is traced once in each mode: its calibration runs inside
the JAX wrapper's first ``process`` (YOLOXDetector; YOLOv8Detector for
YOLOv8n and YOLO11n), and its int8 predictions in the wrapper's own
``infer`` program, made to return the decoded predictions and every
quantized convolution's input (sown by an ``nn.intercept_methods``
interceptor) beside its detections.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from flax.traverse_util import flatten_dict

from test_torch_port_faults import _yolox_csplayers
from tracklab_tpu.models import quantize as JQ
from tracklab_tpu.models.yolo11 import YOLO11 as JYOLO11
from tracklab_tpu.models.yolov8 import YOLOv8 as JYOLOv8
from tracklab_tpu.models.yolox import YOLOX as JYOLOX
from tracklab_tpu.ops.csp_pallas import csp_pallas_supported
from tracklab_tpu.wrappers.bbox_detector.rtmdet_api import \
    RTMDetDetector as JRTMDetDetector
from tracklab_tpu.wrappers.bbox_detector.yolov8_api import \
    YOLOv8Detector as JYOLOv8Detector
from tracklab_tpu.wrappers.bbox_detector.yolox_api import \
    YOLOXDetector as JYOLOXDetector
from tracklab_torch.models import quantize as TQ
from tracklab_torch.models.convert import (module_torch_key,
                                           quant_from_flax, yolov8_from_flax,
                                           yolox_from_flax, yolox_torch_key)
from tracklab_torch.models.yolo11 import YOLO11
from tracklab_torch.models.yolov8 import YOLOv8
from tracklab_torch.models.yolox import YOLOX, CSPLayer
from tracklab_torch.wrappers.bbox_detector import (RTDETRDetector,
                                                   RTMDetDetector,
                                                   YOLOv8Detector,
                                                   YOLOXDetector)

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

SIZE, B = 64, 2
FAMILIES = {
    # name: (JAX model, port model, variant, weight map, key map, pixel
    #        divisor, kernel gain, (JAX wrapper, port wrapper, its variant,
    #        its min_confidence))
    "yolox_nano": (JYOLOX, YOLOX, "nano", yolox_from_flax, yolox_torch_key,
                   1.0, 1.0, (JYOLOXDetector, YOLOXDetector, "nano", 0.25)),
    "yolov8n": (JYOLOv8, YOLOv8, "n", yolov8_from_flax, module_torch_key,
                255.0, 2.0, (JYOLOv8Detector, YOLOv8Detector, "n", 0.3)),
    "yolo11n": (JYOLO11, YOLO11, "n", yolov8_from_flax, module_torch_key,
                255.0, 2.0, (JYOLOv8Detector, YOLOv8Detector, "11n", 0.3)),
}


def _draw(jmodel, seed, gain):
    """Seeded flax variables at (SIZE, SIZE) without an init program:
    kernels N(0, gain / fan_in) (YOLOX's lecun-normal init for 0-255
    pixels, gain 1: a He draw there saturates every score at 1 and clips
    every box to the frame; He, gain 2, for the [0, 1] YOLOv8 family, as
    test_torch_yolov8.py draws it), BN scales and variances in [0.5, 1.5],
    biases and means N(0, 0.1), so that every parameter shows."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            return rng.normal(0, np.sqrt(gain / fan_in), a.shape).astype(
                np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return rng.normal(0, 0.1, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _conv_inputs(model, store):
    """Forward pre-hooks recording the input of every int8 convolution of
    a port model under its module name (the Focus stem's, which its Focus
    runs, under its ConvBnAct's)."""
    hooks = []
    for name, m in model.named_modules():
        if type(m).__name__ == "Focus":
            key = f"{name}.conv"
        elif getattr(m, "quant", None) == "int8" and hasattr(m, "ascale"):
            key = name
        else:
            continue
        hooks.append(m.register_forward_pre_hook(
            lambda mod, a, k=key: store.setdefault(k, a[0])))
    return hooks


def _recorder(next_fun, args, kwargs, context):
    """Sow the input of every quantized flax convolution under
    ``intermediates`` (an ``nn.intercept_methods`` interceptor)."""
    mod = context.module
    if context.method_name == "__call__" and \
            "ascale" in mod.variables.get("quant", {}):
        mod.sow("intermediates", "qin", args[0])
    return next_fun(*args, **kwargs)


def _predict_recording(model, variables, images):
    with nn.intercept_methods(_recorder):
        return model.apply(variables, images, method=type(model).predict,
                           mutable=["intermediates"])


def _recording_infer(jdet):
    """The JAX wrapper's ``_make_infer`` (predict, then
    ``postprocess_detections`` with its thresholds, jitted), whose program
    also returns the decoded predictions and the quantized convolutions'
    inputs: ``process`` reads its usual keys, and the test reads the rest
    from the same compiled program."""
    from tracklab_tpu.ops.nms import postprocess_detections

    def make_infer(model, variables):
        def infer(images):
            decoded, state = _predict_recording(model, variables,
                                                jdet._preproc(images))
            out = postprocess_detections(
                decoded, conf_threshold=jdet.min_confidence,
                iou_threshold=jdet.nms_iou, max_out=jdet.max_dets)
            return {**out, "decoded": decoded,
                    "intermediates": state["intermediates"]}
        return jax.jit(infer)

    return make_infer


def _qins(intermediates):
    return {path[:-1]: np.asarray(v[0] if isinstance(v, tuple) else v)
            for path, v in flatten_dict(intermediates).items()}


def _frames(seed):
    return np.random.default_rng(seed).integers(
        0, 256, (B, SIZE, SIZE, 3), dtype=np.uint8)


def _batch(images):
    return {"image": images, "scale": np.ones(B, np.float32),
            "pad": np.zeros((B, 2), np.float32),
            "shape": np.full((B, 2), SIZE, np.float32)}


def _metadatas():
    return pd.DataFrame({"video_id": [0] * B}, index=[10, 11])


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    """One family's JAX and port runs on one seeded batch."""
    name = request.param
    jcls, tcls, variant, to_torch, key_fn, div, gain, wrap = FAMILIES[name]
    variables = _draw(jcls(num_classes=2, variant=variant), 7, gain)
    images = _frames(8)
    x = images.astype(np.float32) / np.float32(div)
    out = {"name": name, "key_fn": key_fn, "x": x}
    # JAX: the wrapper's first batch calibrates; its infer program also
    # returns the decoded predictions and the convolutions' inputs
    jdet = wrap[0](variant=wrap[2], num_classes=2, input_size=(SIZE, SIZE),
                   min_confidence=wrap[3], max_dets=16, batch_size=B,
                   quant="int8")
    jdet._variables = variables
    jdet._make_infer = _recording_infer(jdet)
    out["jax_rows"] = pd.DataFrame(jdet.process(_batch(images), None,
                                                _metadatas()))
    qvars = jdet._qvars
    res = jdet._infer(images)
    pred, ins = res["decoded"], res["intermediates"]
    out["jax_quant"] = jax.tree_util.tree_map(np.asarray, qvars["quant"])
    out["jax_pred"], out["jax_ins"] = np.asarray(pred), _qins(ins)

    # the port: its own calibration, then the int8 model on JAX's scales
    sd = to_torch({k: variables[k] for k in ("params", "batch_stats")})

    def model(quant):
        m = tcls(num_classes=2, variant=variant, device="cpu", quant=quant)
        m.load_state_dict(sd, strict=True)
        return m

    xt = torch.from_numpy(x)
    out["port_scales"] = TQ.calibrate_int8(model("calib"), [xt])
    int8 = TQ.load_quant_state_dict(
        model("int8"), quant_from_flax(out["jax_quant"], key_fn))
    ins = {}
    hooks = _conv_inputs(int8, ins)
    with torch.no_grad():
        out["port_pred"] = int8.predict(xt).numpy()
    for h in hooks:
        h.remove()
    out["port_ins"], out["int8"] = ins, int8
    tdet = wrap[1](variant=wrap[2], num_classes=2, input_size=(SIZE, SIZE),
                   min_confidence=wrap[3], max_dets=16, batch_size=B,
                   quant="int8", device="cpu")
    tdet._model = model(None)
    out["port_rows"] = tdet.process(_batch(images), None, _metadatas())
    out["port_det"] = tdet
    return out


# ----------------------------------------------------- quant_conv_int8


# (B, H, W, Cin, Cout, kernel, stride, pad): a 3x3 conv, a strided one, a
# 1x1 one, and YOLOX's fused Focus stem (6x6 / 2 over 3 channels, K = 108)
CONV_SHAPES = {"3x3": (2, 12, 12, 8, 16, 3, 1, 1),
               "3x3_s2": (2, 13, 13, 16, 24, 3, 2, 1),
               "1x1": (2, 10, 10, 32, 8, 1, 1, 0),
               "focus_6x6_s2": (2, 16, 16, 3, 16, 6, 2, 2)}


def _jax_codes_and_acc(x, k, ascale, stride, pad):
    """JAX's quant_conv_int8 taken apart: input codes, weight codes and
    scales, int32 accumulators, dequantized output."""
    xq = jnp.clip(jnp.round(jnp.asarray(x) / jnp.float32(ascale)), -127.0,
                  127.0).astype(jnp.int8)
    wscale = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(k)), axis=(0, 1, 2))
                         / 127.0, 1e-12)
    wq = jnp.round(jnp.asarray(k) / wscale).astype(jnp.int8)
    acc = jax.lax.conv_general_dilated(
        xq, wq, (stride, stride), [(pad, pad)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    y = JQ.quant_conv_int8(jnp.asarray(x), jnp.asarray(k),
                           jnp.float32(ascale), (stride, stride),
                           [(pad, pad)] * 2)
    return [np.asarray(a) for a in (xq, wq, wscale, acc, y)]


@pytest.mark.parametrize("integer", [True, False], ids=["integers", "random"])
@pytest.mark.parametrize("shape", list(CONV_SHAPES))
def test_quant_conv_int8_plain_equals_jax(shape, integer):
    """Exact: the port's codes, weight scales, plain int32 accumulators and
    dequantized output are JAX's bit for bit. On integer-valued inputs
    with a per-channel absmax of 127 (ascale 1, wscale 1) int8 is lossless,
    so the output also equals the f32 convolution."""
    b, h, w, cin, cout, ks, s, p = CONV_SHAPES[shape]
    rng = np.random.default_rng(hash(shape) % 1000)
    if integer:
        x = rng.integers(-127, 128, (b, h, w, cin)).astype(np.float32)
        k = rng.integers(-126, 127, (ks, ks, cin, cout)).astype(np.float32)
        k[0, 0, 0, :] = 127.0
        ascale = np.float32(1.0)
    else:
        x = rng.normal(0, 3, (b, h, w, cin)).astype(np.float32)
        k = rng.normal(0, 0.2, (ks, ks, cin, cout)).astype(np.float32)
        ascale = np.float32(np.abs(x).max() / 127.0)
    jxq, jwq, jws, jacc, jy = _jax_codes_and_acc(x, k, ascale, s, p)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(k).permute(3, 2, 0, 1)
    xq = TQ.quantize_input(xt, torch.tensor(ascale))
    wq, ws = TQ.quantize_weight(wt)
    acc = TQ.int8_conv_accumulators_plain(xq, wq, s, p)
    y = TQ.quant_conv_int8(xt, wt, torch.tensor(ascale), s, p)
    np.testing.assert_array_equal(xq.permute(0, 2, 3, 1).numpy(), jxq)
    np.testing.assert_array_equal(wq.permute(2, 3, 1, 0).numpy(), jwq)
    np.testing.assert_array_equal(ws.numpy(), jws)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(), jacc)
    np.testing.assert_array_equal(y.permute(0, 2, 3, 1).numpy(), jy)
    if integer:
        ref = jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(k), (s, s), [(p, p)] * 2,
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        np.testing.assert_array_equal(y.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(ref))


def test_int_mm_route_shapes_pad_to_its_rules():
    """The card's route pads K and N to multiples of 8 and the rows past 16;
    its im2col (``as_strided`` windows) is checked here against the plain
    version by standing ``torch._int_mm`` in with an int64 product (the
    CPU's ``_int_mm`` needs no padding, so the padded shapes are what is
    checked)."""
    calls = []

    def int_mm(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0
        return (a.long() @ b.long()).int()

    orig = torch._int_mm
    torch._int_mm = int_mm
    try:
        for shape in CONV_SHAPES.values():
            b, h, w, cin, cout, ks, s, p = shape
            g = torch.Generator().manual_seed(ks * 10 + cin)
            xq = torch.randint(-127, 128, (b, cin, h, w), generator=g,
                               dtype=torch.int8)
            wq = torch.randint(-127, 128, (cout, cin, ks, ks), generator=g,
                               dtype=torch.int8)
            got = TQ._int_mm_conv(xq.contiguous(
                memory_format=torch.channels_last), wq, s, p)
            want = TQ.int8_conv_accumulators_plain(xq, wq, s, p)
            assert torch.equal(got, want)
        tiny = torch.randint(-127, 128, (1, 8, 2, 2), dtype=torch.int8)
        w1 = torch.randint(-127, 128, (5, 8, 1, 1), dtype=torch.int8)
        assert torch.equal(TQ._int_mm_conv(tiny, w1, 1, 0),
                           TQ.int8_conv_accumulators_plain(tiny, w1, 1, 0))
    finally:
        torch._int_mm = orig
    # the Focus stem: K = 6 * 6 * 3 = 108 padded to 112, N = 16
    assert (calls[3][0][1], calls[3][1]) == (112, (112, 16))
    assert calls[-1][0] == (32, 8) and calls[-1][1] == (8, 8)


# ------------------------------------------------------- the models


def test_calib_visits_the_jax_conv_paths(family):
    """The port's calibrated modules are JAX's ``qstats`` paths (the same
    dense convolutions, the Focus stem's 6x6 one included)."""
    want = set(quant_from_flax(family["jax_quant"], family["key_fn"]))
    assert set(family["port_scales"]) == want
    assert len(want) == len(TQ.quant_modules(family["int8"], "int8"))


def test_calibrated_scales_match_jax(family):
    """Each ``ascale = max(absmax, 1e-6) / 127`` within 2e-6 relative of
    JAX's. The absmax is taken on the float calibration forward, whose
    f32 convolutions (summed in another order than XLA's) and SiLU part
    from JAX's by up to 1.3e-6 relative at the deepest head layers of these
    seeded draws (the worst is printed); the int8 codes that the scales
    feed still all agree (``test_int8_predictions_match_jax``)."""
    want = quant_from_flax(family["jax_quant"], family["key_fn"])
    rel = {k: abs(v.item() - want[k].item()) / want[k].item()
           for k, v in family["port_scales"].items()}
    worst = max(rel, key=rel.get)
    print(f"{family['name']}: scales within {rel[worst]:.3g} relative "
          f"({worst})", sorted(rel.values())[-5:])
    assert all(v.dtype == torch.float32
               for v in family["port_scales"].values())
    assert rel[worst] <= 2e-6, worst


def test_int8_predictions_match_jax(family, record_property):
    """On JAX's scales: every quantized convolution's input codes equal
    JAX's but for the few that a last-ulp difference of the float
    activations moves across a rounding boundary (counted and reported;
    at most 1e-3 of them), and the decoded predictions within 1e-4
    relative and 1e-3 px (xywh: the seeded draws put boxes at thousands of
    px) and 1e-4 (the sigmoid scores) of JAX's."""
    scales = quant_from_flax(family["jax_quant"], family["key_fn"])
    jins = {family["key_fn"](("quant",) + path + ("ascale",))[
        :-len(".ascale")]: v for path, v in family["jax_ins"].items()}
    assert set(jins) == set(family["port_ins"])
    n_codes = n_diff = 0
    for name, xin in family["port_ins"].items():
        a = scales[f"{name}.ascale"]
        got = TQ.quantize_input(xin, a).permute(0, 2, 3, 1).numpy()
        want = TQ.quantize_input(torch.from_numpy(jins[name]).permute(
            0, 3, 1, 2), a).permute(0, 2, 3, 1).numpy()
        n_codes += want.size
        n_diff += int((got != want).sum())
        assert np.abs(got.astype(int) - want).max(initial=0) <= 1, name
    record_property("int8_codes_differing", f"{n_diff} of {n_codes}")
    print(f"{family['name']}: {n_diff} of {n_codes} int8 codes differ")
    assert n_diff <= 1e-3 * n_codes
    got, want = family["port_pred"], family["jax_pred"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], rtol=0, atol=1e-4)


def test_detector_wrapper_int8_matches_jax(family, record_property):
    """``quant="int8"`` (YOLOXDetector; YOLOv8Detector with "n" and "11n"):
    the first ``process`` calibrates on its batch, the scales within 2e-6 of
    the JAX wrapper's own calibration (as above); with those scales of JAX
    loaded into the port's int8 model, the same batch gives JAX's rows: the
    same rows, ids and classes, boxes within 1e-4 relative and 1e-3 px,
    scores within 1e-4. On its own scales the port's rows part from JAX's
    where the scales' last-ulp differences move input codes across a
    rounding boundary (amplified by these seeded draws' activations); per
    frame the count of rows is within 1 of JAX's and the best score within
    1e-2 (the rows whose box and score both agree are counted and
    reported)."""
    det, want = family["port_det"], family["jax_rows"]
    want_scales = quant_from_flax(family["jax_quant"], family["key_fn"])
    assert set(det._scales) == set(want_scales)
    for k, v in det._scales.items():
        np.testing.assert_allclose(v.item(), want_scales[k].item(),
                                   rtol=2e-6)
    own = family["port_rows"]
    agree = 0
    for image_id, w in want.groupby("image_id"):
        g = own[own["image_id"] == image_id]
        assert abs(len(g) - len(w)) <= 1, image_id
        assert abs(g["bbox_conf"].max() - w["bbox_conf"].max()) <= 1e-2
        for box, conf in zip(g["bbox_ltwh"], g["bbox_conf"]):
            agree += any(np.allclose(box, b, rtol=1e-4, atol=1e-3)
                         and abs(conf - c) <= 1e-4
                         for b, c in zip(w["bbox_ltwh"], w["bbox_conf"]))
    record_property("rows_agreeing_on_own_scales", f"{agree} of {len(want)}")
    print(f"{family['name']}: on its own scales {agree} of {len(want)} rows "
          "agree with JAX's")
    TQ.load_quant_state_dict(det._int8_model, want_scales)
    det._detect = None
    det.id = 0
    got = det.process(_batch(_frames(8)), None, _metadatas())
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(got.index, np.arange(len(want)))
    np.testing.assert_array_equal(got["image_id"], want["image_id"])
    np.testing.assert_array_equal(got["category_id"], want["category_id"])
    np.testing.assert_allclose(np.stack(got["bbox_ltwh"]),
                               np.stack(want["bbox_ltwh"]), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(got["bbox_conf"], want["bbox_conf"], rtol=0,
                               atol=1e-4)


# ---------------------------------------------------- routes and limits


@pytest.mark.parametrize("quant", [None, "calib", "int8"])
def test_k3_refuses_every_csplayer_of_a_quantized_model(quant, monkeypatch):
    """YOLOX-s at 640 (meta tensors): K3 admits a CSPLayer exactly where
    JAX's ``csp_pallas_supported`` does, which is none in a calib or int8
    model."""
    # JAX's rule with its kernel asked for (it is opt-in there)
    monkeypatch.setenv("TRACKLAB_TPU_CSP_BACKEND", "pallas")
    model = YOLOX(num_classes=1, variant="s", device="meta", quant=quant)
    seen = []
    for name, m in model.named_modules():
        if isinstance(m, CSPLayer):
            m.register_forward_pre_hook(
                lambda mod, a: seen.append((tuple(a[0].shape),
                                            mod.k3_admits(a[0]))))
    with torch.no_grad():
        model(torch.zeros(1, 640, 640, 3, device="meta"))
    # the 7 layers of 80 x 80 or less that K3 takes in the float model
    # (test_torch_port_faults.py's list) and dark2's at 160 x 160
    small = {(1, cin, H, H) for _, H, cin, _, _, _ in
             _yolox_csplayers("s", 640)}
    assert len(seen) == 8 and small <= {s for s, _ in seen}
    for (b, c, h, w), admitted in seen:
        assert admitted == csp_pallas_supported((b, h, w, c), False, quant,
                                                False)
    assert sum(a for _, a in seen) == (7 if quant is None else 0)


def test_rtmdet_and_lightweight_rtdetr_int8_raise_in_both_packages():
    """JAX's RTMDet wrapper calibrates a YOLOX model on RTMDet's weights at
    its first batch and fails there; the port raises a ValueError at
    construction, before any batch. The lightweight RT-DETR inherits the
    same ``calibrate`` in JAX; the HF RT-DETR ignores ``quant`` in both
    packages."""
    from tracklab_tpu.models.rtmdet import RTMDet as JRTMDet

    jdet = JRTMDetDetector(num_classes=1, input_size=(SIZE, SIZE),
                           quant="int8", batch_size=1)
    jdet._variables = _draw(JRTMDet(num_classes=1, variant="nano"), 0,
                            2.0)
    batch = {k: v[:1] for k, v in _batch(_frames(1)).items()}
    with pytest.raises(Exception) as caught:
        jdet.process(batch, None, _metadatas().iloc[:1])
    assert "calibrate" in "".join(
        f.name for f in caught.traceback), caught.value
    with pytest.raises(ValueError, match="RTMDet has no int8 model"):
        RTMDetDetector(quant="int8", device="cpu")
    with pytest.raises(ValueError, match="lightweight RT-DETR"):
        RTDETRDetector(variant="s", quant="int8", device="cpu")
    assert not RTDETRDetector(variant="r18vd", quant="int8",
                              device="cpu")._int8
    assert YOLOXDetector(quant="int8", device="cpu")._int8
