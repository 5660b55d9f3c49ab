"""The port's YOLOv8 / YOLO11 against the JAX package's on the CPU: the
per-level head maps and ``decode_v8`` of YOLOv8n and YOLO11n at 64 x 64
(weights carried across by ``yolov8_from_flax`` / ``yolo11_from_flax``),
``convert_yolov8_torch`` on the port's own state dict written with
ultralytics' key names, the wrapper's stubs, the wrapper's fused rows
against its staged rows and JAX's, and ``+experiment=mot17_ocsort`` on a
MOT17-layout tree against JAX's staged run, id for id.

The JAX weights are seeded numpy draws on the flax trees' shapes (no init
program is compiled): He-normal kernels, the port's own seeded draw for the
command-line runs (identity BN, zero biases) and, for the head maps, BN
statistics and biases drawn too, so that every parameter shows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from tracklab_tpu import main as JM
from tracklab_tpu.config import compose as jcompose
from tracklab_tpu.models.yolo11 import YOLO11 as JYOLO11
from tracklab_tpu.models.yolov8 import YOLOv8 as JYOLOv8
from tracklab_tpu.models.yolov8 import decode_v8 as jdecode_v8
from tracklab_torch import main as TM
from tracklab_torch.config import compose as tcompose
from tracklab_torch.models.convert import (convert_yolov8_torch,
                                           yolo11_from_flax, yolov8_from_flax)
from tracklab_torch.models.yolo11 import YOLO11
from tracklab_torch.models.yolov8 import YOLOv8, decode_v8
from tracklab_torch.wrappers.bbox_detector import YOLOv8Detector

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

FAMILIES = {"v8n": (JYOLOv8, YOLOv8, yolov8_from_flax, "n"),
            "11n": (JYOLO11, YOLO11, yolo11_from_flax, "n")}


def _variables(jmodel, size, seed, full=True):
    """Seeded flax variables of ``jmodel`` at a (size, size) input:
    He-normal kernels; with ``full`` BN scales and variances in [0.5, 1.5]
    and biases and means N(0, 0.1), else identity BN and zero biases."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            return rng.normal(0, np.sqrt(2.0 / fan_in), a.shape).astype(
                np.float32)
        if name in ("var", "scale"):
            return (rng.uniform(0.5, 1.5, a.shape) if full
                    else np.ones(a.shape)).astype(np.float32)
        return (rng.normal(0, 0.1, a.shape) if full
                else np.zeros(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_head_maps_and_decode_match_jax(family):
    jcls, tcls, convert, variant = FAMILIES[family]
    jmodel = jcls(num_classes=1, variant=variant)
    variables = _variables(jmodel, 64, seed=1)
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    # one compile instead of an eager dispatch per flax op
    want = jax.jit(jmodel.apply)(variables, x)
    model = tcls(num_classes=1, variant=variant, device="cpu")
    model.load_state_dict(convert(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [(2, 8, 8, 65), (2, 4, 4, 65),
                                             (2, 2, 2, 65)]
    for g, w in zip(got, want):
        w = np.asarray(w)
        # f32 convolutions summed in another order: 1e-5 of each map's scale
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    # decoded boxes in input pixels (64): DFL softmax over 16 bins
    np.testing.assert_allclose(decode_v8(got, 1).numpy(),
                               np.asarray(jdecode_v8(want, 1)), rtol=0,
                               atol=2e-3)


def test_convert_yolov8_torch_round_trips():
    """The port's YOLOv8n state dict, written as an ultralytics checkpoint
    holds it (``model.model.`` keys, BN's num_batches_tracked, the DFL
    projection, half precision), loads back into a fresh model; keys
    without the ``model.`` prefix load too; a missing tensor raises."""
    src = YOLOv8(num_classes=2, variant="n", device="cpu").randomize_(3)
    sd = src.state_dict()
    ultra = {f"model.{k}": v.half() for k, v in sd.items()}
    for k in list(sd):
        if k.endswith("running_var"):
            ultra["model." + k.replace("running_var",
                                       "num_batches_tracked")] = \
                torch.tensor(7)
    ultra["model.model.22.dfl.conv.weight"] = torch.arange(16.0).view(
        1, 16, 1, 1)
    got = convert_yolov8_torch(ultra, YOLOv8(num_classes=2, variant="n",
                                             device="cpu"))
    for k, v in got.state_dict().items():
        torch.testing.assert_close(v, sd[k].half().float(), rtol=0, atol=0)
    bare = {k[len("model."):]: v for k, v in sd.items()}
    got = convert_yolov8_torch(bare, YOLOv8(num_classes=2, variant="n",
                                            device="cpu"))
    torch.testing.assert_close(got.state_dict(), sd)
    del bare["22.cv3.0.2.bias"]
    with pytest.raises(ValueError, match="missing"):
        convert_yolov8_torch(bare, YOLOv8(num_classes=2, variant="n",
                                          device="cpu"))


def test_stubs_name_their_roadmap_items():
    """(The name is from before these hooks were ported.) ``quant="int8"``
    builds each family's int8 model (tests/test_torch_quantize.py holds it
    against JAX); the training hooks are ported
    (tests/test_torch_detector_train.py holds them against JAX):
    ``detection_loss_fn`` reads the model's reg_max, and
    ``train_tracking=true`` does not train the detector, as in JAX."""
    for variant, cls in (("n", YOLOv8), ("11n", YOLO11)):
        q = YOLOv8Detector(variant=variant, quant="int8", device="cpu")
        model = q._make_model("int8")
        assert isinstance(model, cls) and model.quant == "int8"
        assert sum(getattr(m, "quant", None) == "int8" and hasattr(
            m, "ascale") for m in model.modules()) > 0
    det = YOLOv8Detector(variant="n", num_classes=1, device="cpu")
    det._model = YOLOv8(num_classes=1, variant="n", device="cpu")
    maps = [torch.zeros((1, 64 // s, 64 // s, 65), requires_grad=True)
            for s in (8, 16, 32)]
    loss = det.detection_loss_fn(maps, torch.tensor(
        [[[20.0, 20.0, 16.0, 16.0, 0.0]]]), torch.tensor([[True]]), (64, 64),
        1)
    loss.backward()
    assert torch.isfinite(loss) and float(maps[0].grad.abs().max()) > 0
    assert not det.training_enabled


# ----------------------------------------------------- the command line
SIZE = 128
DETECT = [f"modules.bbox_detector.input_size=[{SIZE},{SIZE}]",
          "modules.bbox_detector.min_confidence=0.5012",
          "modules.bbox_detector.max_dets=16",
          "modules.bbox_detector.batch_size=4",
          "modules.track.min_confidence=0.5012",
          "modules.track.det_thresh=0.5015",
          "modules.track.max_dets=16", "modules.track.max_tracks=32",
          "use_rich=false", "num_cores=2"]


def _mot17_tree(root, n_videos=2, n_frames=12):
    """A MOT17-layout val split of PNG frames at 128 x 128 (the letterbox
    is then the identity): four blocks moving over a ramp, their boxes as
    gt.txt."""
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


def _jax_cli(args, variables):
    cfg = jcompose(JM.CONFIG_DIR, "config", args)
    JM.init_environment(cfg)
    parts = JM.build(cfg)
    parts["modules"][0]._variables = variables
    parts["engine"].track_dataset()
    return parts["tracker_state"].detections_pred


def _torch_cli(args, ckpt):
    """The port's CLI run up to its tracked rows, as ``_jax_cli`` runs
    JAX's (the tests compare rows, not the evaluation)."""
    cfg = tcompose(TM.CONFIG_DIR, "config", args + [
        "device=cpu", f"modules.bbox_detector.checkpoint_path={ckpt}"])
    parts = TM.build(cfg, TM.init_environment(cfg))
    parts["engine"].track_dataset()
    return parts["tracker_state"].detections_pred


@pytest.fixture(scope="module")
def mot17_data(tmp_path_factory):
    return _mot17_tree(tmp_path_factory.mktemp("mot17"))


@pytest.fixture(scope="module")
def mot17_runs(mot17_data, tmp_path_factory):
    """JAX's staged ``+experiment=mot17_ocsort`` run on the tree with
    seeded YOLOv8n weights, and the port's staged and fused runs on the
    same weights (carried across by ``yolov8_from_flax``)."""
    data = mot17_data
    variables = _variables(JYOLOv8(num_classes=1, variant="n"), SIZE,
                           seed=0, full=False)
    ckpt = tmp_path_factory.mktemp("yolov8n") / "yolov8n.pt"
    torch.save(yolov8_from_flax(variables), ckpt)
    args = ["+experiment=mot17_ocsort", f"data_dir={data}"] + DETECT
    want = _jax_cli(args + ["engine.fused=false"], variables)
    runs = {fused: _torch_cli(args + [f"engine.fused={fused}"], ckpt)
            for fused in ("false", "true")}
    return want, runs


def _assert_same_rows(got, want):
    assert len(want) > 2 * 12 * 3, "too few detections to mean much"
    pd.testing.assert_index_equal(got.index, want.index)
    for col in ("image_id", "video_id", "category_id"):
        np.testing.assert_array_equal(got[col].to_numpy(float),
                                      want[col].to_numpy(float),
                                      err_msg=col)
    np.testing.assert_allclose(np.stack(got["bbox_ltwh"].to_numpy()),
                               np.stack(want["bbox_ltwh"].to_numpy()),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["bbox_conf"].to_numpy(float),
                               want["bbox_conf"].to_numpy(float), rtol=0,
                               atol=1e-6)
    wv, gv = want["track_id"].notna(), got["track_id"].notna()
    assert wv.sum() > 0, "the tracker emitted nothing"
    np.testing.assert_array_equal(gv.to_numpy(), wv.to_numpy())
    np.testing.assert_array_equal(got.loc[gv, "track_id"].to_numpy(float),
                                  want.loc[wv, "track_id"].to_numpy(float))


@pytest.mark.parametrize("fused", ["false", "true"], ids=["staged", "fused"])
def test_mot17_experiment_matches_jax_staged(mot17_runs, fused):
    """``+experiment=mot17_ocsort`` (mot17.yaml, yolov8.yaml, oc_sort.yaml)
    with the input cut to 128 and thresholds set for seeded weights: the
    port's staged and fused runs against JAX's staged run, id for id."""
    want, runs = mot17_runs
    _assert_same_rows(runs[fused], want)


def test_wrapper_fused_rows_equal_staged_rows(mot17_runs):
    """The port's counterpart of tests/test_fused_pipeline.py:589: the
    YOLOv8 wrapper's fused closure divides by 255 as its staged path does,
    so the two runs give the same rows, boxes and scores."""
    _, runs = mot17_runs
    a, b = runs["true"], runs["false"]
    pd.testing.assert_index_equal(a.index, b.index)
    np.testing.assert_array_equal(np.stack(a["bbox_ltwh"].to_numpy()),
                                  np.stack(b["bbox_ltwh"].to_numpy()))
    np.testing.assert_array_equal(a["bbox_conf"].to_numpy(float),
                                  b["bbox_conf"].to_numpy(float))
    np.testing.assert_array_equal(a["track_id"].to_numpy(float),
                                  b["track_id"].to_numpy(float))


def test_yolo11_wrapper_matches_jax(mot17_data, tmp_path):
    """yolo11.yaml's wrapper (variant 11n here, 80 classes) staged against
    JAX's on one sequence of the tree: rows, classes and scores (the
    detector alone: the tracker is held above)."""
    variables = _variables(JYOLO11(num_classes=80, variant="n"), SIZE,
                           seed=5, full=False)
    ckpt = tmp_path / "yolo11n.pt"
    torch.save(yolo11_from_flax(variables), ckpt)
    args = ["+experiment=mot17_ocsort", f"data_dir={mot17_data}",
            "dataset.nvid=1", "pipeline=[bbox_detector]",
            "modules/bbox_detector=yolo11",
            "modules.bbox_detector.variant=11n"] + DETECT
    want = _jax_cli(args, variables)
    got = _torch_cli(args, ckpt)
    assert len(want) >= 4
    pd.testing.assert_index_equal(got.index, want.index)
    np.testing.assert_array_equal(got["category_id"].to_numpy(float),
                                  want["category_id"].to_numpy(float))
    np.testing.assert_allclose(np.stack(got["bbox_ltwh"].to_numpy()),
                               np.stack(want["bbox_ltwh"].to_numpy()),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["bbox_conf"].to_numpy(float),
                               want["bbox_conf"].to_numpy(float), rtol=0,
                               atol=1e-6)
