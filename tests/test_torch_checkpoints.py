"""Checkpoint files in the port against the JAX package on the CPU:
``load_checkpoint`` on a Megvii training-layout YOLOX file (``module.``
keys under ``model``, ``head.grids``), an mmdet-layout RTMDet file (under
``state_dict``), a TorchScript archive and a folded-BN .onnx file (written
as tests/test_onnx_weights.py writes one), each loaded by both packages with
equal outputs; the runtime-only formats raising, and an empty directory
raising the orbax reader's error;
every wrapper's load reading a training checkpoint; and the port's manifests
against the JAX package's.

The JAX converters build their target tree with ``model.init``; here it is
a tree of zeros from ``jax.eval_shape`` (nothing compiles), since every
leaf is replaced by the file's."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_onnx_weights import _fold_conv_bn, onnx_bytes
from tracklab_tpu.models import convert as JC
from tracklab_tpu.models import manifest as JM
from tracklab_tpu.models.rtmdet import RTMDet as JRTMDet
from tracklab_tpu.models.yolox import YOLOX as JYOLOX
from tracklab_torch.models import convert as TC
from tracklab_torch.models import manifest as TM
from tracklab_torch.models.onnx_weights import parse_onnx_initializers
from tracklab_torch.models.rtmdet import RTMDet
from tracklab_torch.models.yolox import YOLOX

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

SIZE = 64
MANIFESTS = Path(__file__).parent / "manifests"


def _seeded_yolox():
    """YOLOX-nano (one class) with seeded weights and BN statistics away
    from the identity, so that folding BN into the convs is not trivial."""
    model = YOLOX(num_classes=1, variant="nano", device="cpu").randomize_(4)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for k, t in model.state_dict().items():
            if k.endswith("running_mean") or k.endswith("bn.bias"):
                t.copy_(torch.from_numpy(rng.normal(0, 0.2, t.shape)))
            elif k.endswith("running_var") or k.endswith("bn.weight"):
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)))
    return model


@pytest.fixture(scope="module")
def yolox_files(tmp_path_factory):
    """A seeded port YOLOX-nano and its weights as a Megvii training file,
    a TorchScript archive and a folded-BN .onnx file."""
    root = tmp_path_factory.mktemp("ckpt")
    model = _seeded_yolox()
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    megvii = {"module." + k: v for k, v in sd.items()}
    megvii["head.grids"] = torch.zeros(3, 1)   # Megvii's training leftovers
    megvii["head.strides"] = torch.tensor([8, 16, 32])
    torch.save({"start_epoch": 300, "model": megvii,
                "optimizer": {"state": {}, "param_groups": []}},
               root / "yolox_nano_megvii.pth")
    # the tracer's own re-trace check is left out: the test holds the
    # archive's outputs to the source model's bit for bit
    torch.jit.trace(model, torch.zeros(1, SIZE, SIZE, 3),
                    check_trace=False).save(
        str(root / "yolox_nano.torchscript"))
    folded = _fold_conv_bn({k: v.numpy() for k, v in sd.items()}, eps=1e-3)
    folded["onnx::Reshape_412"] = np.array([1, -1, 4], np.int64)
    (root / "yolox_nano_folded.onnx").write_bytes(onnx_bytes(folded))
    return root, model


def _zeros_init(jm):
    """A tree of zeros in the shapes of ``jm.init`` at a SIZE x SIZE input,
    traced by ``jax.eval_shape`` (nothing compiles)."""
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                  shapes)


@pytest.fixture(scope="module")
def jax_yolox_zeros():
    return _zeros_init(JYOLOX(num_classes=1, variant="nano"))


@pytest.fixture
def jax_yolox_init(jax_yolox_zeros, monkeypatch):
    """JAX's YOLOX ``init`` answering with the tree of zeros (the
    converters read only its structure)."""
    monkeypatch.setattr(JYOLOX, "init",
                        lambda self, *a, **kw: jax_yolox_zeros)


@pytest.fixture(scope="module")
def jax_yolox_apply():
    jm = JYOLOX(num_classes=1, variant="nano")
    return jax.jit(jm.apply)


def _images(seed, n=2):
    return np.random.default_rng(seed).uniform(
        0, 255, (n, SIZE, SIZE, 3)).astype(np.float32)


def _same_maps(got, want, what):
    for level, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"{what} level {level}")


@pytest.mark.parametrize("name", ["yolox_nano_megvii.pth",
                                  "yolox_nano.torchscript",
                                  "yolox_nano_folded.onnx"])
def test_yolox_files_load_in_both_packages(yolox_files, jax_yolox_init,
                                           jax_yolox_apply, name):
    """Each file loads into the port's YOLOX and JAX's, and the two give
    the same head maps (within 1e-4 of each level's largest value, f32),
    and the maps of the seeded source model (bit for bit for the torch
    files; within 1e-4 for the folded .onnx file, whose convs carry the BN
    scale)."""
    root, source = yolox_files
    path = root / name
    assert TC.checkpoint_kind(path) == JC.checkpoint_kind(path)
    model = TC.load_checkpoint(path, YOLOX(num_classes=1, variant="nano",
                                           device="cpu"))
    variables = JC.load_checkpoint(path, JYOLOX(num_classes=1,
                                                variant="nano"),
                                   (1, SIZE, SIZE, 3))
    # JAX's .onnx load gives its BN scales as weak-typed float64, which
    # the f32 convolutions read as f32: the same apply, without a second
    # compile of it for those dtypes
    variables = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a,
        variables)
    x = _images(6)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        ref = source(torch.from_numpy(x))
    _same_maps(got, jax_yolox_apply(variables, jnp.asarray(x)), name)
    for g, r in zip(got, ref):
        if name.endswith(".onnx"):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                       atol=1e-4 * r.abs().max().item())
        else:
            torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_onnx_initializers_and_folding_match_jax(yolox_files):
    """The protobuf reader gives JAX's arrays, and the folded file's BN
    pass-through loads as JAX's does (weight sqrt(1 + eps), the conv's
    bias as BN bias, mean 0, var 1); the graph's shape constants are not
    read as weights."""
    from tracklab_tpu.models.onnx_weights import \
        parse_onnx_initializers as jparse
    from tracklab_torch.models.onnx_weights import convert_onnx_folded_bn
    path = yolox_files[0] / "yolox_nano_folded.onnx"
    got, want = parse_onnx_initializers(path), jparse(path)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model = YOLOX(num_classes=1, variant="nano", device="cpu")
    sd = convert_onnx_folded_bn(got, model, bn_eps=1e-3)
    assert set(sd) == set(model.state_dict())
    key = "backbone.backbone.stem.conv"
    np.testing.assert_array_equal(sd[f"{key}.bn.bias"],
                                  got[f"{key}.conv.bias"])
    np.testing.assert_allclose(sd[f"{key}.bn.weight"], np.sqrt(1.001),
                               rtol=1e-7)
    assert not sd[f"{key}.bn.running_mean"].any()
    assert (sd[f"{key}.bn.running_var"] == 1).all()
    bad = dict(got)
    bad["backbone.extra_branch.conv.weight"] = np.zeros((4, 4, 1, 1),
                                                        np.float32)
    with pytest.raises(ValueError, match="unused"):
        TC._torch_converter_for(model)(
            convert_onnx_folded_bn(bad, model), model)


def test_rtmdet_mmdet_file_loads_in_both_packages(tmp_path, monkeypatch):
    """An mmdet-layout RTMDet-nano file (``meta``, tensors under
    ``state_dict``) written from a seeded port model: both packages load
    it, and their head maps agree within 1e-4 of each one's largest
    value."""
    model = RTMDet(num_classes=1, variant="nano", device="cpu").randomize_(2)
    path = tmp_path / "rtmdet_nano_8xb32-300e_coco.pth"
    torch.save({"meta": {"epoch": 300, "mmdet_version": "3.3.0"},
                "state_dict": model.state_dict()}, path)
    got = TC.load_checkpoint(path, RTMDet(num_classes=1, variant="nano",
                                          device="cpu"))
    jm = JRTMDet(num_classes=1, variant="nano")
    zeros = _zeros_init(jm)
    monkeypatch.setattr(JRTMDet, "init", lambda self, *a, **kw: zeros)
    variables = JC.load_checkpoint(path, jm, (1, SIZE, SIZE, 3))
    x = _images(8, n=1) / 255.0
    with torch.no_grad():
        maps = got(torch.from_numpy(x))
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    flat_got = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), maps))
    flat_want = jax.tree_util.tree_leaves(want)
    assert len(flat_got) == len(flat_want) > 0
    for g, w in zip(flat_got, flat_want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())
    for k, v in model.state_dict().items():
        torch.testing.assert_close(got.state_dict()[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("suffix", [".engine", ".trt", ".tflite",
                                    ".mlmodel", "_orbax_dir"])
def test_runtime_formats_and_orbax_raise(tmp_path, suffix):
    """The runtime-only exports raise in both packages with JAX's words; a
    directory, which both packages take for an orbax checkpoint, raises the
    port's orbax reader's ValueError where it holds no orbax _METADATA (the
    port reads the JAX package's orbax directories: test_torch_orbax.py)."""
    path = tmp_path / f"model{suffix}"
    model = YOLOX(num_classes=1, variant="nano", device="cpu")
    if suffix == "_orbax_dir":
        path.mkdir()
        assert JC.checkpoint_kind(path) == TC.checkpoint_kind(path) == "orbax"
        with pytest.raises(ValueError, match="no orbax _METADATA.*OCDBT"):
            TC.load_checkpoint(path, model)
        return
    for package in (TC, JC):
        with pytest.raises(ValueError, match="runtime-specific exports"):
            package.checkpoint_kind(path)
    with pytest.raises(ValueError, match="runtime-specific exports"):
        TC.load_checkpoint(path, model)


def test_pickled_checkpoint_needs_allow_pickle(tmp_path):
    """A file that ``weights_only=True`` refuses raises ValueError unless
    ``allow_pickle=True``, as in the JAX package."""
    model = YOLOX(num_classes=1, variant="nano", device="cpu").randomize_(1)
    path = tmp_path / "pickled.pt"
    torch.save({"model": model.state_dict(), "args": _Args()}, path)
    with pytest.raises(ValueError, match="allow_pickle"):
        TC.load_checkpoint(path, YOLOX(num_classes=1, variant="nano",
                                       device="cpu"))
    got = TC.load_checkpoint(path, YOLOX(num_classes=1, variant="nano",
                                         device="cpu"), allow_pickle=True)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(got.state_dict()[k], v, rtol=0, atol=0)


class _Args:
    """A pickled object no weights-only load accepts (a trainer's args)."""
    lr = 0.01


def _training_file(model, path, key):
    """``model``'s tensors as a training checkpoint: under ``key``, with
    DataParallel's ``module.`` prefixes."""
    torch.save({"epoch": 3, key: {"module." + k: v for k, v in
                                  model.state_dict().items()}}, path)
    return str(path)


def _same_state(got, want):
    own = got.state_dict()
    assert set(own) == set(want.state_dict())
    for k, v in want.state_dict().items():
        torch.testing.assert_close(own[k].cpu(), v, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("wrapper", ["yolox", "rtmdet", "yolov8",
                                     "bottomup", "topdown", "pitchseg",
                                     "osnet", "zoo"])
def test_every_wrapper_reads_a_training_checkpoint(tmp_path, wrapper):
    """F5: each wrapper's load takes a training checkpoint (tensors under
    ``model``, ``state_dict`` or ``ema``, ``module.`` prefixes) and holds
    exactly the source model's tensors."""
    from tracklab_torch.models import pose
    from tracklab_torch.wrappers.bbox_detector import (RTMDetDetector,
                                                       YOLOv8Detector,
                                                       YOLOXDetector)
    from tracklab_torch.wrappers.calibration_api import PitchLineDetector
    from tracklab_torch.wrappers.pose_estimator.bottomup_api import \
        BottomUpPoseEstimator
    from tracklab_torch.wrappers.pose_estimator.topdown_api import \
        build_topdown_model
    from tracklab_torch.wrappers.reid.osnet_api import (build_backbone,
                                                        build_osnet)
    cpu = dict(device="cpu")
    if wrapper in ("yolox", "rtmdet", "yolov8", "bottomup", "pitchseg"):
        cls, kw = {
            "yolox": (YOLOXDetector, dict(variant="nano")),
            "rtmdet": (RTMDetDetector, dict(variant="nano")),
            "yolov8": (YOLOv8Detector, dict(variant="n")),
            "bottomup": (BottomUpPoseEstimator, dict(variant="nano")),
            "pitchseg": (PitchLineDetector, dict(variant="nano")),
        }[wrapper]
        source = cls(**kw, **cpu)
        source._build()
        source = source._model.randomize_(7) if hasattr(
            source._model, "randomize_") else pose.randomize_(
                source._model, 7)
        key = {"yolox": "model", "rtmdet": "state_dict",
               "yolov8": "ema"}.get(wrapper, "state_dict")
        module = cls(**kw, checkpoint_path=_training_file(
            source, tmp_path / "w.pth", key), **cpu)
        module._build()
        _same_state(module._model, source)
    elif wrapper == "topdown":
        source = build_topdown_model("t", "csp", "nano", 17, (64, 48), None,
                                     "cpu")
        pose.randomize_(source, 7)
        got = build_topdown_model("t", "csp", "nano", 17, (64, 48),
                                  _training_file(source, tmp_path / "w.pth",
                                                 "state_dict"), "cpu")
        _same_state(got, source)
    elif wrapper == "osnet":
        source = build_osnet("o", "x0_25", 64, 4, False, None, "cpu")
        source.randomize_(7)
        got = build_osnet("o", "x0_25", 64, 4, False,
                          _training_file(source, tmp_path / "w.pth",
                                         "state_dict"), "cpu")
        _same_state(got, source)
    else:
        source = build_backbone("z", "mobilenetv2_x1_0", 512, (64, 32),
                                None, "cpu")
        source.randomize_(7)
        got = build_backbone("z", "mobilenetv2_x1_0", 512, (64, 32),
                             _training_file(source, tmp_path / "w.pth",
                                            "state_dict"), "cpu")
        _same_state(got, source)


@pytest.mark.parametrize("family", ["yolox_nano", "rtmdet_nano",
                                    "osnet_x1_0", "mobilenetv2_reid"])
def test_manifest_keys_match_jax(family):
    """The port's key set of a family equals JAX's ``expected_torch_keys``
    (the converter's name map over its canonical build)."""
    assert TM.expected_torch_keys(family) == JM.expected_torch_keys(family)


@pytest.mark.parametrize("family", sorted(TM.FAMILIES))
def test_manifest_keys_match_frozen_manifests(family):
    """Every family's key set equals the JAX package's frozen manifest
    (tests/manifests/), which JAX's own test holds to its live map."""
    frozen = json.loads((MANIFESTS / f"{family}.json").read_text())
    assert TM.expected_torch_keys(family) == frozen


def test_family_discovery_matches_jax(tmp_path):
    """File names map to the same families, and discovery finds the same
    files, as in the JAX package; ``validate_checkpoint`` loads a found
    file and runs the model (on the CPU when asked; its default device is
    the card)."""
    names = ["yolox_s.pth", "yolov8n.pt", "yolo11n-pose.pt", "yolo11s.pt",
             "rtmdet_tiny_8xb32.pth", "osnet_x1_0_msmt17.pth.tar",
             "resnet50_fc512.pth", "resnet50mid.pth", "train_59.pt",
             "unknown.pt", "kpr_occ_posetrack.pth"]
    for n in names:
        assert TM.family_for_checkpoint(n) == JM.family_for_checkpoint(n), n
    model = YOLOX(num_classes=80, variant="nano", device="cpu").randomize_(0)
    (tmp_path / "sub").mkdir()
    torch.save({"model": model.state_dict()},
               tmp_path / "sub" / "yolox_nano.pth")
    (tmp_path / "notes.txt").write_text("x")
    assert TM.discover_checkpoints(tmp_path) == \
        JM.discover_checkpoints(tmp_path)
    (path, family), = TM.discover_checkpoints(tmp_path)
    out = TM.validate_checkpoint(path, family, device="cpu")
    assert len(out) == 3 and all(torch.isfinite(m).all() for m in out)
    if not torch.cuda.is_available():
        # the entry point runs on the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="cuda"):
            TM.validate_checkpoint(path, family)
