"""The JAX package's orbax checkpoints in the port (``models/orbax_io.py``,
``models/convert.py``) against the JAX package's own ``save_checkpoint``
and ``load_checkpoint`` on the CPU.

Bit-equal means equal dtype, shape and bits (bfloat16 compared as its
``uint16`` view). The flax trees of the model families are seeded numpy
draws on the shapes of ``jax.eval_shape`` of each family's init, read from
``tests/data/torch_orbax/flax_shapes.json.gz`` (an eval_shape costs as
much as the forward's trace; ``PYTHONPATH=. python
tests/test_torch_orbax.py`` rewrites it and the committed fixture
``tests/data/torch_orbax/{ocdbt,plain,expected.npz}``; the ReID zoo's
shapes come from ``tests/data/reid_zoo_flax_shapes.json.gz``)."""
import gzip
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracklab_tpu.models import convert as JC
from tracklab_torch.models import convert as TC
from tracklab_torch.models import orbax_io as IO

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

DATA = Path(__file__).parent / "data" / "torch_orbax"
SHAPES = DATA / "flax_shapes.json.gz"
ZOO_SHAPES = Path(__file__).parent / "data" / "reid_zoo_flax_shapes.json.gz"
LAYOUTS = ("ocdbt", "plain")
# KPR at test_torch_kpr.py's size; the lightweight RT-DETR at the wrapper's
# defaults but for the query count; RT-DETR HF at test_torch_rtdetr.py's
KPR_ARCH = dict(num_parts=5, dim_reduce_output=32, img_size=(64, 32),
                patch_size=16, stride=16, embed_dim=64, depth=2,
                num_heads=2)
HF_TINY = dict(num_labels=3, d_model=32, num_queries=20, embedding_size=8,
               hidden_sizes=(8, 16, 32, 64), depths=(1, 1, 1, 1),
               layer_type="basic", encoder_hidden_dim=32,
               encoder_in_channels=(16, 32, 64), encoder_ffn_dim=64,
               num_attention_heads=4, decoder_layers=2, decoder_ffn_dim=64,
               decoder_attention_heads=4)
ZOO = ("mobilenetv2_x1_0", "nasnetamobile")


# ------------------------------------------------------------- families

def _jax_family(name):
    """The JAX package's model of a family and its init input shape."""
    from tracklab_tpu.models import kpr as JK
    from tracklab_tpu.models import pose as JP
    from tracklab_tpu.models import rtdetr_hf as JH
    from tracklab_tpu.models import vitpose as JV
    from tracklab_tpu.models import yolo11 as JY
    from tracklab_tpu.models.deeplabv3 import DeepLabV3
    from tracklab_tpu.models.osnet import OSNet
    from tracklab_tpu.models.rtdetr import RTDETR
    from tracklab_tpu.models.rtmdet import RTMDet
    from tracklab_tpu.models.segmentation import PitchSegNet
    from tracklab_tpu.models.yolov8 import YOLOv8
    from tracklab_tpu.models.yolox import YOLOX
    sq = (1, 64, 64, 3)
    return {
        "yolox_nano": (YOLOX(num_classes=1, variant="nano"), sq),
        "yolox_s": (YOLOX(num_classes=1, variant="s"), sq),
        "yolov8": (YOLOv8(num_classes=1, variant="n"), sq),
        "yolo11": (JY.YOLO11(num_classes=1, variant="n"), sq),
        "yolo11_pose": (JY.YOLO11Pose(num_classes=1, num_keypoints=17,
                                      variant="n"), sq),
        "yoloxpose": (JP.YOLOXPose(num_classes=1, num_keypoints=17,
                                   variant="nano"), sq),
        "topdown": (JP.TopDownPose(num_keypoints=17, variant="nano"),
                    (1, 64, 48, 3)),
        "simcc": (JP.SimCCPose(num_keypoints=17, variant="nano",
                               input_size=(64, 48)), (1, 64, 48, 3)),
        "vitpose": (JV.ViTPose(num_keypoints=17, variant="tiny"),
                    (1, 64, 48, 3)),
        "rtmdet": (RTMDet(num_classes=1, variant="nano"), sq),
        "rtdetr": (RTDETR(num_classes=1, num_queries=10, variant="tiny"), sq),
        "rtdetr_hf": (JH.RTDetrHF(config=JH.RTDetrHFConfig(**HF_TINY),
                                  num_labels=3), sq),
        "osnet": (OSNet(variant="x0_25", n_parts=4, feat_dim=64),
                  (1, 128, 64, 3)),
        "kpr": (JK.KPR(n_prompt_ch=7, **KPR_ARCH), (1, 64, 32, 3)),
        "pitchseg": (PitchSegNet(num_classes=21, variant="nano"),
                     (1, 64, 128, 3)),
        "deeplabv3": (DeepLabV3(layers=(1, 1, 1, 1)), (1, 64, 64, 3)),
    }[name]


def _port_model(name):
    """The port's model of the same configuration, on the CPU."""
    from tracklab_torch.models import kpr as TK
    from tracklab_torch.models import pose as TP
    from tracklab_torch.models import rtdetr_hf as TH
    from tracklab_torch.models import vitpose as TV
    from tracklab_torch.models import yolo11 as TY
    from tracklab_torch.models.deeplabv3 import DeepLabV3
    from tracklab_torch.models.osnet import OSNet
    from tracklab_torch.models.rtdetr import RTDETR
    from tracklab_torch.models.rtmdet import RTMDet
    from tracklab_torch.models.segmentation import PitchSegNet
    from tracklab_torch.models.yolov8 import YOLOv8
    from tracklab_torch.models.yolox import YOLOX
    from tracklab_torch.wrappers.reid.osnet_api import select_backbone_model
    cpu = dict(device="cpu")
    if name in ZOO:
        return select_backbone_model(name, crop_size=(64, 32), **cpu)
    return {
        "yolox_nano": lambda: YOLOX(num_classes=1, variant="nano", **cpu),
        "yolox_s": lambda: YOLOX(num_classes=1, variant="s", **cpu),
        "yolov8": lambda: YOLOv8(num_classes=1, variant="n", **cpu),
        "yolo11": lambda: TY.YOLO11(num_classes=1, variant="n", **cpu),
        "yolo11_pose": lambda: TY.YOLO11Pose(num_classes=1, num_keypoints=17,
                                             variant="n", **cpu),
        "yoloxpose": lambda: TP.YOLOXPose(num_classes=1, num_keypoints=17,
                                          variant="nano", **cpu),
        "topdown": lambda: TP.TopDownPose(num_keypoints=17, variant="nano",
                                          **cpu),
        "simcc": lambda: TP.SimCCPose(num_keypoints=17, variant="nano",
                                      input_size=(64, 48), **cpu),
        "vitpose": lambda: TV.ViTPose(num_keypoints=17, variant="tiny",
                                      input_size=(64, 48), **cpu),
        "rtmdet": lambda: RTMDet(num_classes=1, variant="nano", **cpu),
        "rtdetr": lambda: RTDETR(num_classes=1, num_queries=10,
                                 variant="tiny", input_size=(64, 64), **cpu),
        "rtdetr_hf": lambda: TH.RTDetrHF(config=TH.RTDetrHFConfig(**HF_TINY),
                                         **cpu),
        "osnet": lambda: OSNet("x0_25", 64, 4, **cpu),
        "kpr": lambda: TK.KPR(n_prompt_ch=7, **KPR_ARCH, **cpu),
        "pitchseg": lambda: PitchSegNet(21, "nano", **cpu),
        "deeplabv3": lambda: DeepLabV3(layers=(1, 1, 1, 1), **cpu),
    }[name]()


def _from_flax(name, tree):
    """The family's ``*_from_flax`` on ``tree``: a model of the port
    holding its weights."""
    if name == "osnet":
        return TC.osnet_from_flax(tree, n_parts=4, device="cpu")
    if name in ZOO:
        return TC.reid_backbone_from_flax(tree, name, crop_size=(64, 32),
                                          device="cpu")
    fn = {"yolox_nano": TC.yolox_from_flax, "yolox_s": TC.yolox_from_flax,
          "yolov8": TC.yolov8_from_flax, "yolo11": TC.yolo11_from_flax,
          "yolo11_pose": TC.yolo11_from_flax,
          "yoloxpose": TC.yoloxpose_from_flax,
          "topdown": TC.topdownpose_from_flax,
          "simcc": TC.simccpose_from_flax, "vitpose": TC.vitpose_from_flax,
          "rtmdet": TC.rtmdet_from_flax, "rtdetr": TC.rtdetr_from_flax,
          "rtdetr_hf": TC.rtdetr_hf_from_flax, "kpr": TC.kpr_from_flax,
          "pitchseg": TC.pitchsegnet_from_flax,
          "deeplabv3": TC.deeplabv3_from_flax}[name]
    model = _port_model(name)
    model.load_state_dict(fn(tree), strict=True)
    return model


FAMILIES = ("yolox_nano", "yolox_s", "yolov8", "yolo11", "yolo11_pose",
            "yoloxpose", "topdown", "simcc", "vitpose", "rtmdet", "rtdetr",
            "rtdetr_hf", "osnet", "kpr", "pitchseg", "deeplabv3")


def write_shapes():
    """Write SHAPES: each family's variables as {"collection/.../leaf":
    shape}, from ``jax.eval_shape`` of the init the JAX package's
    ``load_checkpoint`` restores against."""
    out = {}
    for name in FAMILIES:
        model, shape = _jax_family(name)
        tree = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), *JC.init_inputs(model, shape),
            train=False))
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        out[name] = {"/".join(k.key for k in path): list(a.shape)
                     for path, a in flat}
    DATA.mkdir(parents=True, exist_ok=True)
    with gzip.open(SHAPES, "wt") as f:
        json.dump(out, f, sort_keys=True, separators=(",", ":"))


def flax_tree(name, seed=0):
    """Seeded numpy variables (f32) on the flax tree of family ``name``:
    kernels N(0, 1 / fan_in), norm scales and variances in [0.5, 1.5], the
    rest N(0, 0.1)."""
    src = ZOO_SHAPES if name in ZOO else SHAPES
    with gzip.open(src, "rt") as f:
        leaves = json.load(f)[name]
    rng = np.random.default_rng(seed)
    tree = {}
    for key in sorted(leaves):
        shape = tuple(leaves[key])
        *parents, leaf = key.split("/")
        if leaf == "kernel":
            a = rng.normal(0, np.sqrt(1.0 / max(int(np.prod(shape[:-1])), 1)),
                           shape)
        elif leaf in ("var", "scale"):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.normal(0, 0.1, shape)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = a.astype(np.float32)
    return tree


# ---------------------------------------------------------- the fixture

def fixture_tree(seed=19):
    """The fixture's seeded tree: every dtype the reader decodes, a 0-d
    scalar, a sequence-keyed subtree, and a 64 x 64 f32 kernel (16 KB,
    which OCDBT puts in a data file rather than inline); bf16 as a jax
    array, the rest numpy."""
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "conv": {"kernel": rng.normal(size=(3, 3, 4, 8))
                     .astype(np.float32)},
            "dense": {"kernel": rng.normal(size=(64, 64)).astype(np.float32)},
            "bf16": jnp.asarray(rng.normal(size=(5, 7)), jnp.bfloat16),
            "half": rng.normal(size=(4,)).astype(np.float16),
            "f64": rng.normal(size=(3,)),
            "i8": rng.integers(-128, 128, 6).astype(np.int8),
            "u8": rng.integers(0, 256, 5).astype(np.uint8),
            "i32": rng.integers(-1000, 1000, (2, 3)).astype(np.int32),
            "i64": rng.integers(-2 ** 40, 2 ** 40, 4),
            "mask": rng.integers(0, 2, 7).astype(bool),
            "scale": np.float32(rng.normal()),
            "blocks": [{"w": rng.normal(size=(2, 2)).astype(np.float32)},
                       {"w": rng.normal(size=(2, 2)).astype(np.float32)}],
        },
        "batch_stats": {"bn": {"mean": rng.normal(size=8).astype(np.float32),
                               "var": rng.uniform(0.5, 1.5, 8)
                               .astype(np.float32)}},
    }


def save_jax(path, tree, layout):
    """The JAX package's ``save_checkpoint`` (OCDBT, orbax's default), or
    orbax's ``use_ocdbt=False`` layout."""
    if layout == "ocdbt":
        JC.save_checkpoint(path, tree)
        return
    import orbax.checkpoint as ocp
    ckptr = ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=False))
    ckptr.save(Path(path).absolute(), tree)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _bits(a):
    """(dtype name, shape, bits) of a tensor or array: bf16 as uint16."""
    if torch.is_tensor(a):
        if a.dtype == torch.bfloat16:
            return "bfloat16", tuple(a.shape), \
                a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return "bfloat16", a.shape, a.view(np.uint16)
    return a.dtype.name, a.shape, a


def assert_bit_equal(got, want):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert set(g) == set(w)
    for k in w:
        gd, gs, gb = _bits(g[k])
        wd, ws, wb = _bits(w[k])
        assert (gd, gs) == (wd, ws), (k, gd, gs, wd, ws)
        assert np.array_equal(gb, wb), k


def write_fixture():
    """Write the committed fixture: ``fixture_tree`` through the JAX
    package's ``save_checkpoint`` in both layouts, and ``expected.npz``
    of the same draws (bf16 as its uint16 bits, its keys listed under
    ``__bfloat16__``)."""
    for layout in LAYOUTS:
        shutil.rmtree(DATA / layout, ignore_errors=True)
        save_jax(DATA / layout, fixture_tree(), layout)
    flat = {k: _bits(v) for k, v in _flat(fixture_tree())}
    np.savez(DATA / "expected.npz", __bfloat16__=np.array(
        [k for k, (d, _, _) in flat.items() if d == "bfloat16"]),
        **{k: b for k, (_, _, b) in flat.items()})


def expected_fixture():
    """expected.npz as a flat {key: (dtype name, shape, bits)}."""
    with np.load(DATA / "expected.npz") as z:
        bf16 = set(z["__bfloat16__"].tolist())
        return {k: ("bfloat16" if k in bf16 else z[k].dtype.name,
                    z[k].shape, z[k]) for k in z.files
                if k != "__bfloat16__"}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_fixture_reads_equal_to_its_draws_and_to_jax(layout):
    """The committed fixture, read by the port and restored by the JAX
    package, holds expected.npz's draws bit for bit (orbax's output is not
    byte-deterministic: contents are compared, not files)."""
    want = expected_fixture()
    for tree in (IO.read_orbax(DATA / layout),
                 JC.load_checkpoint(DATA / layout)):
        got = {k: _bits(v) for k, v in _flat(tree)}
        assert set(got) == set(want)
        for k, (d, s, b) in want.items():
            assert got[k][:2] == (d, s), (k, got[k][:2], d, s)
            assert np.array_equal(got[k][2], b), k
    assert json.loads((DATA / layout / "_METADATA").read_text())[
        "use_ocdbt"] == (layout == "ocdbt")


# ------------------------------------------------------ (i) JAX -> port

@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    """The fixture's tree and a 512 x 1024 f32 array (its zstd chunk goes
    to a data file of its own in OCDBT), saved by the JAX package in both
    layouts."""
    root = tmp_path_factory.mktemp("jax_saved")
    tree = fixture_tree(seed=23)
    tree["params"]["big"] = np.random.default_rng(24).normal(
        size=(512, 1024)).astype(np.float32)
    for layout in LAYOUTS:
        save_jax(root / layout, tree, layout)
    return root


@pytest.mark.parametrize("layout", LAYOUTS)
def test_port_reads_jax_save_bit_equal(jax_saved, layout):
    """(i) The JAX package's save, read by the port, is bit-equal to the JAX
    package's ``load_checkpoint`` of it; the port's ``load_checkpoint``
    without a model returns the same tree."""
    path = jax_saved / layout
    want = JC.load_checkpoint(path)
    got = TC.load_checkpoint(path)
    assert_bit_equal(got, want)
    assert isinstance(got["params"]["blocks"], list)
    assert got["params"]["scale"].shape == ()
    if layout == "ocdbt":
        store = IO._Ocdbt(path)
        far = [k for k, v in store.entries.items() if isinstance(v, tuple)]
        assert "params.big/0.0" in far, far


# ------------------------------------------------------ (ii) port -> JAX

@pytest.mark.parametrize("target", ["none", "yolox_nano"])
def test_jax_restores_port_save_bit_equal(tmp_path, monkeypatch, target):
    """(ii) The port's ``save_checkpoint`` (of tensors, bf16 included, or of
    a YOLOX-nano tree of numpy arrays) restored by the JAX package's
    ``load_checkpoint``, without a target and with ``(model,
    input_shape)``: bit-equal."""
    from tracklab_tpu.models.yolox import YOLOX as JYOLOX
    if target == "none":
        tree = jax.tree_util.tree_map(
            lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
                torch.bfloat16) if getattr(a, "dtype", None) == jnp.bfloat16
            else torch.from_numpy(np.array(a)), fixture_tree(seed=29))
        TC.save_checkpoint(tmp_path / "ckpt", tree)
        got = JC.load_checkpoint(tmp_path / "ckpt")
    else:
        tree = flax_tree("yolox_nano", seed=3)
        model = JYOLOX(num_classes=1, variant="nano")
        zeros = jax.tree_util.tree_map(jnp.zeros_like, tree)
        # the restore target's structure (JAX's eval_shape of the init)
        # from the shapes file: nothing traces the model
        monkeypatch.setattr(JYOLOX, "init", lambda self, *a, **kw: zeros)
        TC.save_checkpoint(tmp_path / "ckpt", tree)
        got = JC.load_checkpoint(tmp_path / "ckpt", model, (1, 64, 64, 3))
    assert_bit_equal(got, tree)
    meta = json.loads((tmp_path / "ckpt" / "_METADATA").read_text())
    assert meta["use_ocdbt"] is False and meta["use_zarr3"] is False
    with pytest.raises(ValueError, match="already exists"):
        TC.save_checkpoint(tmp_path / "ckpt", tree)


# ------------------------------------------- (iii) YOLOX-s full width

def test_yolox_s_orbax_checkpoint_detects_as_jax(tmp_path, monkeypatch):
    """(iii) YOLOX-s (full width, one class) saved by the JAX package and
    given as ``checkpoint_path`` to both packages' ``YOLOXDetector``: the
    same detections on a seeded frame, within test_torch_yolox.py's
    tolerance (rel 1e-4 of max(|x|, 1))."""
    from tracklab_tpu.models.yolox import YOLOX as JYOLOX
    from tracklab_tpu.wrappers.bbox_detector.yolox_api import \
        YOLOXDetector as JDetector
    from tracklab_torch.wrappers.bbox_detector import YOLOXDetector
    tree = flax_tree("yolox_s", seed=5)
    JC.save_checkpoint(tmp_path / "yolox_s", tree)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, tree)
    monkeypatch.setattr(JYOLOX, "init", lambda self, *a, **kw: zeros)
    kw = dict(variant="s", num_classes=1, input_size=(128, 128),
              min_confidence=0.3, max_dets=32,
              checkpoint_path=str(tmp_path / "yolox_s"))
    jdet, tdet = JDetector(**kw), YOLOXDetector(device="cpu", **kw)
    jdet._build()
    tdet._build()
    x = np.random.default_rng(7).integers(0, 256, (1, 128, 128, 3),
                                          dtype=np.uint8)
    want = jdet._infer(jnp.asarray(x))
    got = tdet._detect_fn()(torch.from_numpy(x))
    valid = np.asarray(want["valid"])
    assert valid.sum() > 0
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    for g, w in ((got.ltrb, want["ltrb"]), (got.conf, want["score"])):
        g, w = g.numpy()[valid], np.asarray(w)[valid]
        rel = (np.abs(g - w) / np.maximum(np.abs(w), 1.0)).max()
        assert rel < 1e-4, rel
    np.testing.assert_array_equal(got.cls.numpy()[valid],
                                  np.asarray(want["cls"])[valid])


# ------------------------------------- (iv) every family's flax map

@pytest.mark.parametrize("name", FAMILIES + ZOO)
def test_orbax_branch_equals_from_flax(tmp_path, name):
    """(iv) ``load_checkpoint`` of an orbax directory into the family's
    model gives the state dict of the family's ``*_from_flax`` on the same
    tree, bit for bit; bf16 leaves are widened to f32 first (exact)."""
    tree = flax_tree(name, seed=11)
    want = _from_flax(name, tree).state_dict()
    # bf16 on disk: the tree rounded to bf16 loads as its f32 widening
    half = name in ("yolox_nano", "osnet")
    if half:
        tree = jax.tree_util.tree_map(
            lambda a: torch.from_numpy(a).to(torch.bfloat16), tree)
        want = _from_flax(name, jax.tree_util.tree_map(
            lambda t: t.float().numpy(), tree)).state_dict()
    TC.save_checkpoint(tmp_path / name, tree)
    got = TC.load_checkpoint(tmp_path / name, _port_model(name)).state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_flax_map_raises_on_misfit(tmp_path):
    """A tree of another family, or with a tensor missing, raises ValueError
    naming what does not fit; a model without a flax map raises too."""
    tree = flax_tree("yolox_nano")
    TC.save_checkpoint(tmp_path / "nano", tree)
    with pytest.raises(ValueError, match="shape mismatch"):
        TC.load_checkpoint(tmp_path / "nano", _port_model("yolox_s"))
    del tree["params"]["head"]["cls_preds__0"]
    TC.save_checkpoint(tmp_path / "cut", tree)
    with pytest.raises(ValueError, match="missing.*cls_preds.0"):
        TC.load_checkpoint(tmp_path / "cut", _port_model("yolox_nano"))
    with pytest.raises(ValueError, match="No flax weight map"):
        TC.load_checkpoint(tmp_path / "nano", torch.nn.Linear(2, 2))


# ------------------------------------------------------- the wrappers

def _wrapper_model(wrapper, path):
    """The model a port wrapper builds from ``checkpoint_path=path``."""
    from tracklab_torch.wrappers.bbox_detector import (RTDETRDetector,
                                                       RTMDetDetector,
                                                       YOLOXDetector)
    from tracklab_torch.wrappers.calibration_api import PitchLineDetector
    from tracklab_torch.wrappers.pose_estimator.batched_api import \
        TopDownPoseBatched
    from tracklab_torch.wrappers.pose_estimator.bottomup_api import \
        BottomUpPoseEstimator
    from tracklab_torch.wrappers.pose_estimator.topdown_api import \
        build_topdown_model
    from tracklab_torch.wrappers.reid.batched_api import OSNetReIdBatched
    from tracklab_torch.wrappers.reid.kpr_api import build_kpr
    from tracklab_torch.wrappers.reid.osnet_api import (build_backbone,
                                                        build_osnet)
    cpu = dict(device="cpu", checkpoint_path=str(path))
    if wrapper in ("yolox", "rtmdet", "rtdetr", "bottomup", "pitchseg"):
        module = {
            "yolox": lambda: YOLOXDetector(variant="nano", **cpu),
            "rtmdet": lambda: RTMDetDetector(variant="nano", **cpu),
            "rtdetr": lambda: RTDETRDetector(variant="tiny", num_queries=10,
                                             input_size=(64, 64), **cpu),
            "bottomup": lambda: BottomUpPoseEstimator(variant="nano", **cpu),
            "pitchseg": lambda: PitchLineDetector(variant="nano", **cpu),
        }[wrapper]()
        module._build()
        return module._model
    if wrapper == "osnet":
        return build_osnet("o", "x0_25", 64, 4, False, str(path), "cpu")
    if wrapper == "osnet_batched":
        module = OSNetReIdBatched(variant="x0_25", feat_dim=64, n_parts=4,
                                  **cpu)
        module._build()
        return module._model
    if wrapper == "zoo":
        return build_backbone("z", "mobilenetv2_x1_0", 512, (64, 32),
                              str(path), "cpu")
    if wrapper == "kpr":
        return build_kpr("k", KPR_ARCH, 7, str(path), "cpu")
    if wrapper == "topdown":
        return build_topdown_model("t", "csp", "nano", 17, (64, 48),
                                   str(path), "cpu")
    module = TopDownPoseBatched(variant="nano", crop_size=(64, 48), **cpu)
    module.device_pose_fn()
    return module._model


WRAPPERS = {"yolox": "yolox_nano", "rtmdet": "rtmdet", "rtdetr": "rtdetr",
            "bottomup": "yoloxpose", "pitchseg": "pitchseg", "osnet": "osnet",
            "osnet_batched": "osnet", "zoo": "mobilenetv2_x1_0",
            "kpr": "kpr", "topdown": "topdown", "topdown_batched": "topdown"}


@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_every_wrapper_reads_an_orbax_checkpoint(tmp_path, wrapper):
    """Each port wrapper whose JAX counterpart reads an orbax
    ``checkpoint_path`` reads one: its model holds the family's
    ``*_from_flax`` weights of the saved tree exactly."""
    name = WRAPPERS[wrapper]
    tree = flax_tree(name, seed=13)
    TC.save_checkpoint(tmp_path / "ckpt", tree)
    got = _wrapper_model(wrapper, tmp_path / "ckpt").state_dict()
    want = _from_flax(name, tree).state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k].cpu(), v), k


def test_manifest_validates_an_orbax_entry(tmp_path):
    """A manifest entry naming an orbax directory validates: the family's
    canonical build loads it and runs one forward pass."""
    from tracklab_torch.models import manifest as TM
    tree = {"params": {}, "batch_stats": {}}
    model, _ = TM.FAMILIES["yolox_nano"][0]("cpu")
    full = TC.yolox_to_flax(model.randomize_(3))
    tree.update(full)
    TC.save_checkpoint(tmp_path / "yolox_nano", tree)
    out = TM.validate_checkpoint(tmp_path / "yolox_nano", "yolox_nano",
                                 device="cpu")
    assert len(out) == 3 and all(torch.isfinite(m).all() for m in out)


# ------------------------------------------------------------ (v) errors

def _corrupt_node(root):
    node = next(p for p in sorted((root / "d").iterdir()))
    raw = bytearray(node.read_bytes())
    raw[20] ^= 0x40
    node.write_bytes(bytes(raw))


def _zarr3(root):
    meta = json.loads((root / "_METADATA").read_text())
    meta["use_zarr3"] = True
    (root / "_METADATA").write_text(json.dumps(meta))


def _aggregate(root):
    """The older orbax layout: the whole tree as one msgpack file named
    ``checkpoint`` (flax's serialization), no ``_METADATA``."""
    from flax import serialization
    shutil.rmtree(root)
    root.mkdir()
    (root / "checkpoint").write_bytes(serialization.msgpack_serialize(
        {"params": {"w": np.ones((2, 2), np.float32)}}))


def _empty(root):
    shutil.rmtree(root)
    root.mkdir()


@pytest.mark.parametrize("fault,match", [
    (_corrupt_node, "crc32c mismatch"), (_zarr3, "zarr v3"),
    (_aggregate, "aggregate msgpack"), (_empty, "no orbax _METADATA")],
    ids=["crc32c", "zarr3", "aggregate", "empty"])
def test_unreadable_directories_raise(tmp_path, fault, match):
    """(v) A node whose crc32c does not match, a zarr v3 checkpoint, the
    aggregate msgpack layout and an empty directory raise ValueError, each
    naming the file or what the port reads."""
    root = tmp_path / "ckpt"
    shutil.copytree(DATA / "ocdbt", root)
    fault(root)
    with pytest.raises(ValueError, match=match):
        TC.load_checkpoint(root, _port_model("yolox_nano"))
    with pytest.raises(ValueError, match=match):
        IO.read_orbax(root)


def test_missing_libzstd_raises_naming_it(monkeypatch):
    """Without the system zstd library the reader raises RuntimeError naming
    it: there is no second decoder to fall back on."""
    def no_library(name, *a, **kw):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(IO, "_LIB", None)
    monkeypatch.setattr(IO.ctypes, "CDLL", no_library)
    with pytest.raises(RuntimeError, match="libzstd"):
        IO.read_orbax(DATA / "ocdbt")


# ------------------------------------ OCDBT and zarr beyond orbax's use

def test_ocdbt_interior_nodes_against_tensorstore(tmp_path):
    """A database tensorstore writes with tiny nodes (interior levels,
    prefix-compressed keys, inline and indirect values): the reader's keys
    and values equal tensorstore's."""
    import tensorstore as ts
    spec = ts.KvStore.Spec(f"file://{tmp_path}/|ocdbt:").to_json()
    spec["config"] = {"max_decoded_node_bytes": 200,
                      "max_inline_value_bytes": 16,
                      "compression": {"id": "zstd"}}
    kv = ts.KvStore.open(spec).result()
    txn = ts.Transaction()
    want = {f"key{i:03d}/x": (f"v{i}" * (i % 7 + 1)).encode()
            for i in range(60)}
    for k, v in want.items():
        kv.with_transaction(txn)[k] = v
    txn.commit_async().result()
    store = IO._Ocdbt(tmp_path)
    assert set(store.entries) == set(want)
    assert all(store.get(k) == v for k, v in want.items())
    assert any(isinstance(v, tuple) for v in store.entries.values())


def test_zarr_chunks_order_fill_and_compressors(tmp_path):
    """zarr v2 arrays tensorstore writes in the plain layout: several
    chunks with ragged edges, Fortran order, a fill value where a chunk is
    missing, no compressor; read equal to tensorstore's reads."""
    import tensorstore as ts
    specs = {
        "a": (np.random.default_rng(1).normal(size=(5, 7))
              .astype(np.float32), [2, 3], "C", {"id": "zstd", "level": 1}),
        "b": (np.arange(24, dtype=np.int32).reshape(6, 4), [4, 4], "F",
              None),
        "c": (np.random.default_rng(2).normal(size=(4, 4)), [2, 2], "C",
              {"id": "zstd", "level": 3}),
    }
    tree = {}
    for name, (arr, chunks, order, comp) in specs.items():
        meta = {"zarr_format": 2, "shape": list(arr.shape), "chunks": chunks,
                "dtype": arr.dtype.str, "order": order, "compressor": comp,
                "fill_value": 1.5 if name == "c" else None}
        spec = ts.Spec(f"file://{tmp_path}/params.{name}/|zarr2").to_json()
        spec["metadata"] = meta
        t = ts.open(spec, create=True).result()
        if name == "c":
            t[0:2, 0:2].write(arr[0:2, 0:2]).result()   # one chunk of four
        else:
            t.write(arr).result()
        tree[name] = t.read().result()
    (tmp_path / "_METADATA").write_text(json.dumps({
        "tree_metadata": {f"('params', '{n}')": {
            "key_metadata": [{"key": "params", "key_type": 2},
                             {"key": n, "key_type": 2}],
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False}}
            for n in specs}, "use_ocdbt": False, "use_zarr3": False}))
    got = IO.read_orbax(tmp_path)["params"]
    for name, want in tree.items():
        assert got[name].numpy().dtype == want.dtype
        np.testing.assert_array_equal(got[name].numpy(), want)
    assert (got["c"].numpy()[2:, 2:] == 1.5).all()


# ----------------------------------------------- (vi) yolox_to_flax

@pytest.mark.parametrize("name", ["yolox_nano", "yolox_s"])
def test_yolox_to_flax_inverts_yolox_from_flax(name):
    """(vi) ``yolox_to_flax(yolox_from_flax(v)) == v`` bit for bit, and a
    port model's tree is the tree of its state dict."""
    v = flax_tree(name, seed=17)
    assert_bit_equal(TC.yolox_to_flax(TC.yolox_from_flax(v)), v)
    model = _from_flax(name, v)
    assert_bit_equal(TC.yolox_to_flax(model), v)


def test_crc32c_and_zstd_vectors():
    """crc32c's check value (RFC 3720's "123456789" -> 0xE3069283) and a
    zstd frame without a content size decoded at the size it is given."""
    assert IO.crc32c(b"123456789") == 0xE3069283
    raw = (DATA / "plain" / "params.conv.kernel" / "0.0.0.0").read_bytes()
    assert raw[:4] == b"\x28\xb5\x2f\xfd"
    out = IO.zstd_decompress(raw, 3 * 3 * 4 * 8 * 4)
    assert len(out) == 3 * 3 * 4 * 8 * 4
    with pytest.raises(ValueError, match="no expected size"):
        IO.zstd_decompress(raw)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_shapes()
    write_fixture()
