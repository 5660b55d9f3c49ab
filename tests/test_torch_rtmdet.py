"""The port's RTMDet against the JAX package's on the CPU: RTMDet-nano's
per-level cls and reg maps and ``decode_rtmdet`` at 64 x 64 (weights
carried across by ``rtmdet_from_flax``), ``convert_rtmdet_torch`` on the
mmdet-named dict JAX's exporter writes, the ``RTMDetDetector`` wrapper's
staged rows against JAX's wrapper on two frames, and the wrapper's fused
closure (device unletterbox) against its staged rows.

The JAX weights are seeded numpy draws on the flax tree's shapes (no init
program is compiled): lecun-normal kernels, BN scales and variances in
[0.5, 1.5], biases and means N(0, 0.1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from tracklab_tpu.models.convert import (_rtmdet_torch_key,
                                         export_torch_state_dict)
from tracklab_tpu.models.rtmdet import RTMDet as JRTMDet
from tracklab_tpu.models.rtmdet import decode_rtmdet as jdecode
from tracklab_tpu.wrappers.bbox_detector.rtmdet_api import \
    RTMDetDetector as JRTMDetDetector
from tracklab_torch.models.convert import (convert_rtmdet_torch,
                                           rtmdet_from_flax)
from tracklab_torch.models.rtmdet import RTMDet, decode_rtmdet
from tracklab_torch.wrappers.bbox_detector import RTMDetDetector

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

SIZE = 64


def _variables(jmodel, size, seed):
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            return rng.normal(0, np.sqrt(1.0 / fan_in), a.shape).astype(
                np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return rng.normal(0, 0.1, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def nano():
    jmodel = JRTMDet(num_classes=2, variant="nano")
    variables = _variables(jmodel, SIZE, seed=0)
    model = RTMDet(num_classes=2, variant="nano", device="cpu")
    model.load_state_dict(rtmdet_from_flax(variables), strict=True)
    return jmodel, variables, model


def test_maps_and_decode_match_jax(nano):
    jmodel, variables, model = nano
    x = np.random.default_rng(1).normal(0, 1, (2, SIZE, SIZE, 3)).astype(
        np.float32)
    # one compile instead of an eager dispatch per flax op
    want = jax.jit(jmodel.apply)(variables, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert [tuple(c.shape) for c, _ in got] == [(2, 8, 8, 2), (2, 4, 4, 2),
                                                (2, 2, 2, 2)]
    for (gc, gr), (wc, wr) in zip(got, want):
        for g, w in ((gc, wc), (gr, wr)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-4 * np.abs(w).max())
    dec_w = np.asarray(jdecode(want))
    dec_g = decode_rtmdet(got).numpy()
    np.testing.assert_allclose(dec_g[..., :4], dec_w[..., :4], rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(dec_g[..., 4], dec_w[..., 4])
    np.testing.assert_allclose(dec_g[..., 5:], dec_w[..., 5:], rtol=0,
                               atol=1e-5)


def test_convert_rtmdet_torch_loads_the_exported_mmdet_dict(nano):
    """JAX's exporter writes level 0's head kernels only (the levels share
    them); the loader fills every level, keeps the other levels' copies
    unread, drops ``num_batches_tracked`` and raises on a missing
    tensor."""
    jmodel, variables, model = nano
    sd = export_torch_state_dict(jmodel, variables, _rtmdet_torch_key)
    assert "bbox_head.cls_convs.1.0.conv.weight" not in sd
    sd["bbox_head.reg_convs.2.1.conv.weight"] = np.zeros_like(
        sd["bbox_head.reg_convs.0.1.conv.weight"])
    sd["backbone.stem.0.bn.num_batches_tracked"] = np.int64(3)
    got = convert_rtmdet_torch(sd, RTMDet(num_classes=2, variant="nano",
                                          device="cpu"))
    want = model.state_dict()
    for k, v in got.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    del sd["neck.out_convs.1.bn.running_var"]
    with pytest.raises(ValueError, match="missing"):
        convert_rtmdet_torch(sd, RTMDet(num_classes=2, variant="nano",
                                        device="cpu"))


def _frames(n=2, hw=(48, 80), seed=7):
    """Frames of another aspect than the input, so the letterbox pads."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
            for _ in range(n)]


@pytest.fixture(scope="module")
def wrapper_rows(nano, tmp_path_factory):
    """The port's and JAX's RTMDetDetector (nano, 64 x 64, a threshold low
    enough for seeded scores) on the same letterboxed batch."""
    _, variables, model = nano
    ckpt = tmp_path_factory.mktemp("rtmdet") / "rtmdet_nano.pt"
    torch.save(model.state_dict(), ckpt)
    kw = dict(variant="nano", num_classes=2, input_size=(SIZE, SIZE),
              min_confidence=0.3, max_dets=16, batch_size=2)
    tdet = RTMDetDetector(checkpoint_path=str(ckpt), device="cpu", **kw)
    jdet = JRTMDetDetector(**kw)
    jdet._variables = variables
    samples = [tdet.preprocess(f, None, None) for f in _frames()]
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    meta = pd.DataFrame({"video_id": [0, 0]}, index=[10, 11])
    got = tdet.process(batch, None, meta)
    want = pd.DataFrame(jdet.process(batch, None, meta))
    return tdet, batch, got, want


def test_wrapper_rows_match_jax(wrapper_rows):
    _, _, got, want = wrapper_rows
    assert len(want) >= 4, "too few detections to mean much"
    pd.testing.assert_index_equal(got.index, want.index)
    for col in ("image_id", "video_id", "category_id"):
        np.testing.assert_array_equal(got[col].to_numpy(float),
                                      want[col].to_numpy(float))
    np.testing.assert_allclose(np.stack(got["bbox_ltwh"].to_numpy()),
                               np.stack(want["bbox_ltwh"].to_numpy()),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["bbox_conf"].to_numpy(float),
                               want["bbox_conf"].to_numpy(float), rtol=0,
                               atol=1e-5)


def test_device_detect_fn_matches_staged_rows(wrapper_rows):
    """The port's counterpart of tests/test_fused_pipeline.py:583-600: the
    fused closure normalises as the staged path does, and its device
    unletterbox gives the staged rows' boxes and scores."""
    tdet, batch, got, _ = wrapper_rows
    det = tdet.device_detect_fn()(
        torch.from_numpy(batch["image"]),
        {k: torch.from_numpy(np.asarray(batch[k], np.float32))
         for k in ("scale", "pad", "shape")})
    valid = det.valid.numpy()
    ltrb = det.ltrb.numpy()[valid]
    np.testing.assert_array_equal(np.nonzero(valid)[0],
                                  got["image_id"].to_numpy() - 10)
    np.testing.assert_array_equal(
        np.concatenate([ltrb[:, :2], ltrb[:, 2:] - ltrb[:, :2]], axis=1),
        np.stack(got["bbox_ltwh"].to_numpy()))
    np.testing.assert_array_equal(det.conf.numpy()[valid],
                                  got["bbox_conf"].to_numpy(np.float32))


def test_stubs_name_their_roadmap_item():
    """``train`` raises as the JAX wrapper's inherited one fails (YOLOX's
    SimOTA loss on RTMDet's (cls, reg) maps; a reference fault, held in
    both packages by tests/test_torch_detector_train.py), before any
    step, and ``train_tracking=true`` does not call it."""
    det = RTMDetDetector(device="cpu")
    assert not det.training_enabled
    with pytest.raises(TypeError, match="SimOTA"):
        det.train(None)


def test_randomize_is_seeded_with_tied_head():
    """Seeded weights: the same seed gives the same tensors, the head's
    kernels are equal across levels, and the scores and boxes of a frame
    spread (unit-output prediction convs, positive distances)."""
    a = RTMDet(num_classes=1, variant="nano", device="cpu").randomize_(3)
    b = RTMDet(num_classes=1, variant="nano", device="cpu").randomize_(3)
    for k, v in a.state_dict().items():
        torch.testing.assert_close(v, b.state_dict()[k], rtol=0, atol=0)
    for branch in (a.bbox_head.cls_convs, a.bbox_head.reg_convs):
        for lvl in branch[1:]:
            for conv, conv0 in zip(lvl, branch[0]):
                torch.testing.assert_close(conv.conv.weight,
                                           conv0.conv.weight)
    x = torch.nn.functional.interpolate(
        torch.randn(1, 3, 6, 6, generator=torch.Generator().manual_seed(4)),
        size=(96, 96), mode="bilinear").permute(0, 2, 3, 1)
    dec = a.predict(x)[0]
    assert dec[:, 5].std() > 0.05
    assert (dec[:, 2:4] > 0).all(dim=1).float().mean() > 0.8
