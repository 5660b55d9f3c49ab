"""The port's RT-DETR families against the JAX package's on the CPU.

- The lightweight ``RTDETR`` (variant ``tiny``, whose CSP layers are dense
  as at ``s``; dim 32, one decoder layer) at 64 x 64: logits and boxes.
- The deformable sampling alone against JAX's ``_sample_gather`` (points
  outside [0, 1], on integer pixel centres, odd level sizes).
- ``RTDetrHF`` at tests/test_fused_pipeline.py's tiny configuration at 128 x
  128 (logits, boxes, the encoder's top-k), its backbone at 176 x 176 where
  stage 4's shortcut pools an 11 x 11 map (``_avg_pool_ceil2``, not torch's
  ``AvgPool2d(ceil_mode=True)``), and the whole model at 176 failing in
  both packages (the FPN's 2x upsample of 6 x 6 meets 11 x 11).
- ``postprocess_rtdetr`` and the encoder's top-k on exact ties: JAX's
  indices (``lax.top_k``: the lower index first).
- ``convert_rtdetr_hf_torch`` on the HF-named dict JAX's exporter writes.
- The HF wrapper: ``make_rtdetr_detect_fn`` under per-axis scales against
  the staged ``process``; the stubs.
- ``+modules/bbox_detector=rtdetr_hf`` at the tiny configuration (a variant
  name patched into both packages' tables) -> OC-SORT on a 128 x 128
  MOT17-layout tree: the port fused and staged against JAX's staged run,
  id for id.

The JAX weights are seeded numpy draws on the flax trees' shapes (no init
program is compiled).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from tracklab_tpu import main as JM
from tracklab_tpu.config import compose as jcompose
from tracklab_tpu.models import rtdetr_hf as JH
from tracklab_tpu.models.convert import (_rtdetr_hf_torch_key,
                                         export_torch_state_dict)
from tracklab_tpu.models.rtdetr import RTDETR as JRTDETR
from tracklab_tpu.wrappers.bbox_detector.rtdetr_api import \
    RTDETRDetector as JRTDETRDetector
from tracklab_torch import main as TM
from tracklab_torch.config import compose as tcompose
from tracklab_torch.engine.fused import make_rtdetr_detect_fn
from tracklab_torch.models import rtdetr_hf as TH
from tracklab_torch.models.convert import (convert_rtdetr_hf_torch,
                                           rtdetr_from_flax,
                                           rtdetr_hf_from_flax)
from tracklab_torch.models.rtdetr import RTDETR
from tracklab_torch.wrappers.bbox_detector import RTDETRDetector

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

# tests/test_fused_pipeline.py:436-442
TINY = dict(num_labels=3, d_model=32, num_queries=20, embedding_size=8,
            hidden_sizes=(8, 16, 32, 64), depths=(1, 1, 1, 1),
            layer_type="basic", encoder_hidden_dim=32,
            encoder_in_channels=(16, 32, 64), encoder_ffn_dim=64,
            num_attention_heads=4, decoder_layers=2, decoder_ffn_dim=64,
            decoder_attention_heads=4)
SIZE = 128


def _variables(jmodel, shape, seed, **kw):
    """Seeded flax variables on ``jmodel``'s tree: lecun-normal kernels
    (fan-in over all but the last axis; a DenseGeneral's over its input),
    BN scales and variances in [0.5, 1.5], other leaves N(0, 0.1)."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros(shape), **kw))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        if name == "kernel":
            fan_in = (a.shape[0] if a.ndim == 3 and path[-2].key != "out"
                      else int(np.prod(a.shape[:-1])))
            return rng.normal(0, np.sqrt(1.0 / fan_in), a.shape).astype(
                np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return rng.normal(0, 0.1, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_lightweight_rtdetr_matches_jax():
    jmodel = JRTDETR(num_classes=2, num_queries=10, dim=32, dec_layers=1,
                     variant="tiny")
    variables = _variables(jmodel, (1, 64, 64, 3), seed=0, train=False)
    model = RTDETR(num_classes=2, num_queries=10, dim=32, dec_layers=1,
                   variant="tiny", input_size=(64, 64), device="cpu")
    model.load_state_dict(rtdetr_from_flax(variables), strict=True)
    assert not any(m.depthwise for m in model.modules()
                   if type(m).__name__ == "CSPLayer")
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    logits, boxes = jax.jit(lambda v, x: jmodel.apply(v, x))(variables, x)
    with torch.no_grad():
        got_logits, got_boxes = model(torch.from_numpy(x))
    _close(got_logits, logits)
    np.testing.assert_allclose(got_boxes.numpy(), np.asarray(boxes), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("case", ["outside", "pixel_centres"])
def test_deformable_sampling_matches_jax_gather(case):
    """Odd level sizes (5 x 7, 3 x 3, 1 x 2); sampling points spread over
    [-0.3, 1.3] (taps outside the map read zeros), or exactly on pixel
    centres ((i + 0.5) / w), where bilinear weights are 0 and 1."""
    shapes = [(5, 7), (3, 3), (1, 2)]
    B, Q, H, D, P = 2, 6, 2, 4, 3
    L, S = len(shapes), sum(h * w for h, w in shapes)
    rng = np.random.default_rng(3)
    value = rng.normal(size=(B, S, H, D)).astype(np.float32)
    if case == "outside":
        loc = rng.uniform(-0.3, 1.3, (B, Q, H, L, P, 2))
    else:
        loc = np.empty((B, Q, H, L, P, 2))
        for lvl, (h, w) in enumerate(shapes):
            loc[:, :, :, lvl, :, 0] = (rng.integers(0, w, (B, Q, H, P))
                                       + 0.5) / w
            loc[:, :, :, lvl, :, 1] = (rng.integers(0, h, (B, Q, H, P))
                                       + 0.5) / h
    loc = loc.astype(np.float32)
    weights = rng.uniform(0, 1, (B, Q, H, L, P)).astype(np.float32)
    want = JH.MSDeformableAttention._sample_gather(
        None, jnp.asarray(value), jnp.asarray(loc), jnp.asarray(weights),
        shapes)
    got = TH.sample_deformable(torch.from_numpy(value),
                               torch.from_numpy(loc),
                               torch.from_numpy(weights), shapes)
    _close(got, want, rel=1e-5)


@pytest.fixture(scope="module")
def tiny_hf():
    jmodel = JH.RTDetrHF(config=JH.RTDetrHFConfig(**TINY), num_labels=3)
    variables = _variables(jmodel, (1, SIZE, SIZE, 3), seed=2, train=False)
    model = TH.RTDetrHF(config=TH.RTDetrHFConfig(**TINY), device="cpu")
    model.load_state_dict(rtdetr_hf_from_flax(variables), strict=True)
    return jmodel, variables, model


def test_rtdetr_hf_matches_jax(tiny_hf):
    jmodel, variables, model = tiny_hf
    x = np.random.default_rng(4).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(
        np.float32)
    logits, boxes, topk = jax.jit(lambda v, x: jmodel.apply(
        v, x, return_topk=True))(variables, x)
    with torch.no_grad():
        got_logits, got_boxes, got_topk = model(torch.from_numpy(x),
                                                 return_topk=True)
    np.testing.assert_array_equal(got_topk.numpy(), np.asarray(topk))
    _close(got_logits, logits)
    np.testing.assert_allclose(got_boxes.numpy(), np.asarray(boxes), rtol=0,
                               atol=1e-5)


def test_odd_maps_pool_as_jax_and_not_as_ceil_mode(tiny_hf):
    """At 176 x 176 stage 4's shortcut pools an 11 x 11 map: the port's
    backbone equals JAX's, whose pool zero-pads and divides by 4 (torch's
    ``AvgPool2d(2, 2, ceil_mode=True)`` divides an edge window by its
    in-bounds count); the whole model fails in both packages there."""
    ones = torch.ones(1, 1, 3, 3)
    np.testing.assert_array_equal(TH._avg_pool_ceil2(ones)[0, 0].numpy(),
                                  [[1.0, 0.5], [0.5, 0.25]])
    np.testing.assert_array_equal(
        torch.nn.AvgPool2d(2, 2, ceil_mode=True)(ones)[0, 0].numpy(),
        np.ones((2, 2)))
    _, variables, model = tiny_hf
    jbackbone = JH.ResNetDBackbone(JH.RTDetrHFConfig(**TINY))
    bvars = {"params": variables["params"]["model"]["backbone__model"],
             "batch_stats":
                 variables["batch_stats"]["model"]["backbone__model"]}
    x = np.random.default_rng(5).uniform(0, 1, (1, 176, 176, 3)).astype(
        np.float32)
    want = jax.jit(jbackbone.apply)(bvars, x)
    with torch.no_grad():
        got = model.model.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(g.shape[2:]) for g in got] == [(22, 22), (11, 11), (6, 6)]
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1), w)
    with pytest.raises(TypeError):
        jax.eval_shape(lambda: JH.RTDetrHF(
            config=JH.RTDetrHFConfig(**TINY)).init(
                jax.random.PRNGKey(0), jnp.zeros((1, 176, 176, 3))))
    with pytest.raises(RuntimeError), torch.no_grad():
        model(torch.from_numpy(x))


def test_top_k_ties_follow_lax_top_k():
    """Scores with exact ties (the invalid anchors' encoder scores are all
    equal): ``stable_topk`` and ``postprocess_rtdetr`` give ``lax.top_k``'s
    indices and rows."""
    rng = np.random.default_rng(6)
    scores = rng.choice([-1.0, 0.0, 0.5, 2.0], (3, 40)).astype(np.float32)
    vals, idx = jax.lax.top_k(jnp.asarray(scores), 17)
    got_vals, got_idx = TH.stable_topk(torch.from_numpy(scores), 17)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(got_vals.numpy(), np.asarray(vals))
    logits = rng.choice([-3.0, 0.0, 1.0], (2, 12, 3)).astype(np.float32)
    boxes = rng.uniform(0.1, 0.9, (2, 12, 4)).astype(np.float32)
    want = JH.postprocess_rtdetr(jnp.asarray(logits), jnp.asarray(boxes),
                                 img_w=96, img_h=64, conf_threshold=0.5,
                                 max_out=20)
    got = TH.postprocess_rtdetr(torch.from_numpy(logits),
                                torch.from_numpy(boxes), img_w=96, img_h=64,
                                conf_threshold=0.5, max_out=20)
    for k in ("score", "cls", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["ltrb"].numpy(), np.asarray(want["ltrb"]),
                               rtol=0, atol=1e-4)


def test_convert_rtdetr_hf_torch_loads_the_exported_hf_dict(tiny_hf):
    """The HF-named dict JAX's exporter writes, with the decoder's alias
    of the heads, the denoising table and BN's ``num_batches_tracked`` as
    an HF checkpoint holds them, loads into a fresh model equal to the one
    from ``rtdetr_hf_from_flax``; a missing tensor raises."""
    jmodel, variables, model = tiny_hf
    sd = export_torch_state_dict(jmodel, variables, _rtdetr_hf_torch_key)
    for k in [k for k in sd if k.startswith(("bbox_embed.",
                                             "class_embed."))]:
        sd["model.decoder." + k] = sd.pop(k)
    sd["model.denoising_class_embed.weight"] = np.zeros((4, 32), np.float32)
    sd["model.encoder_input_proj.0.1.num_batches_tracked"] = np.int64(1)
    got = convert_rtdetr_hf_torch(sd, TH.RTDetrHF(
        config=TH.RTDetrHFConfig(**TINY), device="cpu"))
    want = model.state_dict()
    for k, v in got.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    del sd["model.enc_output.1.bias"]
    with pytest.raises(ValueError, match="missing"):
        convert_rtdetr_hf_torch(sd, TH.RTDetrHF(
            config=TH.RTDetrHFConfig(**TINY), device="cpu"))


@pytest.fixture
def tiny_variant(monkeypatch):
    """The tiny configuration as a variant name both packages' wrappers
    take for an HF one."""
    cfg = dict(TINY)
    del cfg["num_labels"]
    for table, det in ((JH.RTDETR_HF_VARIANTS, JRTDETRDetector),
                       (TH.RTDETR_HF_VARIANTS, RTDETRDetector)):
        monkeypatch.setitem(table, "tiny_test", cfg)
        monkeypatch.setattr(det, "HF_VARIANTS",
                            det.HF_VARIANTS + ("tiny_test",))
    return "tiny_test"


def test_fused_closure_matches_staged_process(tiny_hf, tiny_variant,
                                              tmp_path):
    """The HF wrapper's fused closure under per-axis scales (frames of 150 x
    110 and 80 x 200 stretched to 128 x 128) gives the staged rows."""
    _, _, model = tiny_hf
    ckpt = tmp_path / "tiny.pt"
    torch.save(model.state_dict(), ckpt)
    det = RTDETRDetector(variant=tiny_variant, num_classes=3,
                         input_size=(SIZE, SIZE), min_confidence=THRESHOLD,
                         max_dets=16, batch_size=2,
                         checkpoint_path=str(ckpt), device="cpu")
    assert det.supports_fused_detect
    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
              for hw in ((110, 150), (200, 80))]
    samples = [det.preprocess(f, None, None) for f in frames]
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    np.testing.assert_allclose(batch["scale"], [[150 / 128, 110 / 128],
                                                [80 / 128, 200 / 128]])
    rows = det.process(batch, None,
                       pd.DataFrame({"video_id": [0, 0]}, index=[3, 4]))
    assert len(rows) >= 4
    fn = make_rtdetr_detect_fn(det._model, (SIZE, SIZE),
                               conf_threshold=THRESHOLD, max_dets=16)
    out = fn(torch.from_numpy(batch["image"]),
             {k: torch.from_numpy(batch[k]) for k in ("scale", "shape")})
    valid = out.valid.numpy()
    ltrb = out.ltrb.numpy()[valid]
    np.testing.assert_array_equal(np.nonzero(valid)[0],
                                  rows["image_id"].to_numpy() - 3)
    np.testing.assert_array_equal(
        np.concatenate([ltrb[:, :2], ltrb[:, 2:] - ltrb[:, :2]], axis=1),
        np.stack(rows["bbox_ltwh"].to_numpy()))
    np.testing.assert_array_equal(out.conf.numpy()[valid],
                                  rows["bbox_conf"].to_numpy(np.float32))


def test_stubs_name_their_roadmap_item():
    det = RTDETRDetector(variant="s", device="cpu")
    assert not det.supports_fused_detect
    with pytest.raises(NotImplementedError, match="HF RT-DETR variants"):
        det.device_detect_fn()
    for call in (lambda: det.detection_loss_fn(None, None, None, None, 1),
                 det.train):
        with pytest.raises(NotImplementedError, match="ROADMAP item 6"):
            call()


# ----------------------------------------------------- the command line
# the seeded tiny model scores 0.74-0.83 everywhere; 0.78 lies in a gap
# between the 6th and 7th best (0.79 and 0.77 on every frame of the tree)
THRESHOLD = 0.78


def _mot17_tree(root, n_videos=2, n_frames=10):
    """A MOT17-layout val split of PNG frames at 128 x 128 (the stretch
    resize is then the identity): blocks moving over a ramp."""
    import cv2
    ramp = np.linspace(20, 90, SIZE, dtype=np.float32)[None, :, None]
    for v in range(n_videos):
        seq = root / "MOT17" / "val" / f"MOT17-{v + 2:02d}-FRCNN"
        (seq / "img1").mkdir(parents=True)
        (seq / "gt").mkdir()
        (seq / "seqinfo.ini").write_text(
            f"[Sequence]\nname={seq.name}\nimDir=img1\nframeRate=30\n"
            f"seqLength={n_frames}\nimWidth={SIZE}\nimHeight={SIZE}\n"
            "imExt=.png\n")
        gt = []
        for f in range(1, n_frames + 1):
            img = np.broadcast_to(ramp, (SIZE, SIZE, 3)).astype(
                np.uint8).copy()
            for t in range(4):
                x = 5 + 28 * t + (3 - v) * f
                y = 15 + 18 * t + v * f
                img[y:y + 36, x:x + 18] = (200 - 40 * t, 60 + 50 * t, 120)
                gt.append(f"{f},{t + 1},{x},{y},18,36,1,1,1.0")
            cv2.imwrite(str(seq / "img1" / f"{f:06d}.png"), img[..., ::-1])
        (seq / "gt" / "gt.txt").write_text("\n".join(gt) + "\n")
    return root


@pytest.fixture
def cli_runs(tiny_hf, tiny_variant, tmp_path):
    _, variables, model = tiny_hf
    data = _mot17_tree(tmp_path)
    ckpt = tmp_path / "tiny.pt"
    torch.save(model.state_dict(), ckpt)
    args = ["+experiment=mot17_ocsort", f"data_dir={data}",
            "modules/bbox_detector=rtdetr_hf",
            f"modules.bbox_detector.variant={tiny_variant}",
            "modules.bbox_detector.num_classes=3",
            f"modules.bbox_detector.input_size=[{SIZE},{SIZE}]",
            f"modules.bbox_detector.min_confidence={THRESHOLD}",
            "modules.bbox_detector.max_dets=16",
            "modules.bbox_detector.batch_size=4",
            f"modules.track.min_confidence={THRESHOLD}",
            f"modules.track.det_thresh={THRESHOLD}",
            "modules.track.max_dets=16", "modules.track.max_tracks=32",
            "use_rich=false", "num_cores=2"]
    cfg = jcompose(JM.CONFIG_DIR, "config", args + ["engine.fused=false"])
    JM.init_environment(cfg)
    parts = JM.build(cfg)
    parts["modules"][0]._variables = variables
    parts["engine"].track_dataset()
    want = parts["tracker_state"].detections_pred
    runs = {}
    for fused in ("false", "true"):
        cfg = tcompose(TM.CONFIG_DIR, "config", args + [
            "device=cpu", f"engine.fused={fused}",
            f"modules.bbox_detector.checkpoint_path={ckpt}"])
        parts = TM.build(cfg, TM.init_environment(cfg))
        parts["engine"].track_dataset()
        runs[fused] = parts["tracker_state"].detections_pred
    return want, runs


def test_rtdetr_hf_cli_matches_jax_staged(cli_runs):
    """The port's staged and fused runs against JAX's staged run: rows,
    boxes, scores and track ids; fused equal to staged bit for bit."""
    want, runs = cli_runs
    assert len(want) > 2 * 10 * 3, "too few detections to mean much"
    for fused, got in runs.items():
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
        wv, gv = want["track_id"].notna(), got["track_id"].notna()
        assert wv.sum() > 0, "the tracker emitted nothing"
        np.testing.assert_array_equal(gv.to_numpy(), wv.to_numpy())
        np.testing.assert_array_equal(
            got.loc[gv, "track_id"].to_numpy(float),
            want.loc[wv, "track_id"].to_numpy(float))
    a, b = runs["true"], runs["false"]
    np.testing.assert_array_equal(np.stack(a["bbox_ltwh"].to_numpy()),
                                  np.stack(b["bbox_ltwh"].to_numpy()))
    np.testing.assert_array_equal(a["track_id"].to_numpy(float),
                                  b["track_id"].to_numpy(float))
