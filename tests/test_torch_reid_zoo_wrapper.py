"""The port's ReID backbone zoo against the JAX package's, on the CPU: the
families test_torch_reid_zoo.py leaves (ResNet50-IBN-a and -b, OSNet-AIN,
HACNN, MuDeep, InceptionV4, InceptionResNetV2, NASNet-A mobile), the
helpers the families rest on (ceil-mode and padded pools, the PCB bins,
the channel shuffle, HACNN's resize and hard-attention sampling), the
backbone keys, both weight loaders, and ``OSNetReId(backbone=...)`` with
``modules/reid=backbone_zoo`` through both command lines.

Weights, crops and the tolerance (f32, 1e-4 of the output's scale) are
test_torch_reid_zoo.py's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import tracklab_tpu.models.nasnet_reid as JN
import tracklab_tpu.models.reid_backbones as JB
import tracklab_torch.models.nasnet_reid as TN
import tracklab_torch.models.reid_backbones as TB
from test_torch_reid_zoo import CROPS, check_family, close, crops
from tracklab_tpu import main as JM
from tracklab_tpu.config import compose as jcompose
from tracklab_tpu.models.convert import (_generic_torch_key,
                                         _inception_torch_key,
                                         export_torch_state_dict)
from tracklab_torch import main as TM
from tracklab_torch.config import compose as tcompose
from tracklab_torch.wrappers.reid import OSNetReId
from tracklab_torch.wrappers.reid.osnet_api import select_backbone_model

torch.set_num_threads(1)


# the families whose weights the checkpoint, wrapper and CLI tests reuse
REUSED = ("resnet50_ibn_a", "inceptionv4")


@pytest.fixture(scope="module")
def checked():
    """check_family's (flax model, variables, port model) of REUSED, kept
    for this module's tests only."""
    store = {}
    yield store
    store.clear()


def family(checked, backbone):
    if backbone not in checked:
        checked[backbone] = check_family(backbone)
    return checked[backbone]


@pytest.mark.parametrize("backbone", [
    "resnet50_ibn_a", "resnet50_ibn_b", "osnet_ain_x1_0", "hacnn", "mudeep",
    "inceptionv4", "inceptionresnetv2", "nasnetamobile"])
def test_family_matches_jax(checked, backbone):
    """IBN-a (the config's default) and IBN-b, OSNet-AIN, HACNN at 160 x 64
    (hard-attention crops of the maps), MuDeep at 256 x 128 (its fc over
    the channel-major flatten), InceptionV4 and InceptionResNetV2 at
    96 x 80, NASNet-A mobile (pad-and-crop pools and shortcuts)."""
    if backbone in REUSED:
        family(checked, backbone)
    else:
        check_family(backbone)


# ----------------------------------------------------------- helpers

def _nhwc(x):
    return jnp.asarray(x.permute(0, 2, 3, 1).numpy())


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _maps(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        0, 1, shape).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 3, 7, 9), (1, 2, 10, 5),
                                   (1, 4, 13, 3)])
def test_pools_match_jax(shape):
    """``MaxPool2d(3, 2, ceil_mode=True)`` against JAX's -inf-padded pool,
    the Inception branches' padding-excluding 3x3 average pool, and
    NASNet's pad-and-crop max
    (-inf) and average (zeros counted) pools, on odd maps."""
    x = _maps(shape)
    for got, want in ((TB._max_pool_ceil3, JB._max_pool_ceil3),
                      (TB._pooled(shape[1], 1)[0], JB._avgp3),
                      (TN._maxpool_pad, JN._maxpool_pad),
                      (TN._avgpool_pad, JN._avgpool_pad)):
        close(got(x), _nchw(jax.jit(want)(_nhwc(x))), 1e-6)


@pytest.mark.parametrize("h,parts", [(7, 6), (4, 6), (9, 4), (12, 6)])
def test_pcb_bins_match_jax(h, parts):
    """``AdaptiveAvgPool2d((parts, 1))`` bins against JAX's row bins, H a
    multiple of ``parts`` or not (bins overlapping where H < parts)."""
    x = _maps((2, 3, h, 5))
    got = TB._adaptive_avg_pool_rows(x, parts)[..., 0]        # (B, C, p)
    want = jax.jit(JB._adaptive_avg_pool_rows, static_argnums=1)(
        _nhwc(x), parts)                                      # (B, p, C)
    close(got, np.swapaxes(np.asarray(want), 1, 2), 1e-6)


def test_channel_shuffle_matches_jax():
    """The NCHW view-transpose gives the JAX package's NHWC permutation."""
    x = torch.arange(2 * 12 * 3 * 2, dtype=torch.float32).view(2, 12, 3, 2)
    np.testing.assert_array_equal(
        TB._channel_shuffle(x, 2).numpy(),
        _nchw(jax.jit(JB._channel_shuffle, static_argnums=1)(
            _nhwc(x), 2)).numpy())


@pytest.mark.parametrize("size", [(24, 28), (6, 7), (11, 3)])
def test_resize_bilinear_ac_matches_jax(size):
    x = _maps((2, 3, 9, 5))
    close(TB._resize_bilinear_ac(x, *size), _nchw(jax.jit(
        JB._resize_bilinear_ac, static_argnums=(1, 2))(_nhwc(x), *size)),
        1e-6)


def test_stn_scale_y_matches_jax():
    """HACNN's hard-attention sampling against JAX's
    ``_grid_sample_bilinear`` path, with translations that put samples
    outside the map (zeros there)."""
    x = _maps((4, 3, 9, 7))
    theta = torch.tensor([[0.0, 0.0], [0.3, -0.5], [-0.9, 0.95],
                          [0.99, -0.99]])
    got = TB._stn_scale_y(x, theta)
    close(got, _nchw(jax.jit(JB._stn_scale_y)(
        _nhwc(x), jnp.asarray(theta.numpy()))), 1e-6)
    assert (got[2:, :, :, -1] == 0).any() or (got[2:, :, :, 0] == 0).any()


# -------------------------------------------------------- keys, weights

def test_backbone_keys_resolve_as_in_jax():
    """Every key of the JAX package's tests/test_reid_pose.py resolves to
    the port's class of the same name; unknown keys and wrong fixed crops
    raise ValueError as there."""
    expected = {
        "osnet": "OSNet", "osnet_ain_x1_0": "OSNetAIN",
        "osnet_ain_x0_25": "OSNetAIN",
        "resnet18": "ReidResNet", "resnet34": "ReidResNet",
        "resnet50": "ReidResNet", "resnet101": "ReidResNet",
        "resnet152": "ReidResNet", "resnet50_fc512": "ReidResNet",
        "resnext50_32x4d": "ReidResNet",
        "resnext101_32x8d": "ReidResNet",
        "resnet50_ibn_a": "ReidResNetIBN",
        "resnet50_ibn_b": "ReidResNetIBNb",
        "resnet50mid": "ReidResNetMid",
        "se_resnet50": "ReidSEResNet",
        "mobilenetv2_x1_0": "ReidMobileNetV2",
        "mobilenetv2_x1_4": "ReidMobileNetV2",
        "shufflenet_v2_x0_5": "ReidShuffleNetV2",
        "shufflenet_v2_x2_0": "ReidShuffleNetV2",
        "densenet121": "ReidDenseNet",
        "squeezenet1_0": "ReidSqueezeNet",
        "mlfn": "ReidMLFN", "pcb_p6": "ReidPCB", "pcb_p4": "ReidPCB",
        "xception": "ReidXception",
        "inceptionv4": "ReidInceptionV4",
        "inceptionresnetv2": "ReidInceptionResNetV2",
        "nasnetamobile": "ReidNASNetAMobile",
        "mudeep": "ReidMuDeep", "hacnn": "ReidHACNN",
    }
    crop = {"hacnn": (160, 64), "mudeep": (256, 128)}
    for name, cls in expected.items():
        model = select_backbone_model(
            name, crop_size=crop.get(name, (256, 128)), device="meta")
        assert type(model).__name__ == cls, name
    with pytest.raises(ValueError, match="Unknown reid backbone"):
        select_backbone_model("definitely_not_a_backbone", device="meta")
    with pytest.raises(ValueError, match="160, 64"):
        select_backbone_model("hacnn", crop_size=(64, 32), device="meta")
    with pytest.raises(ValueError, match="256, 128"):
        select_backbone_model("mudeep", crop_size=(64, 32), device="meta")


@pytest.mark.parametrize("backbone,key_fn", [
    ("resnet50_ibn_a", _generic_torch_key),
    ("inceptionv4", _inception_torch_key)])
def test_torchreid_checkpoint_loads(checked, tmp_path, backbone, key_fn):
    """A torchreid-layout checkpoint, written by the JAX package's
    ``export_torch_state_dict`` with its key function (the Inception names'
    'q' back to '_'), under ``module.`` with classifier heads and BN's
    ``num_batches_tracked`` added, loads through
    ``OSNetReId(checkpoint_path=...)`` and gives ``reid_backbone_from_flax``'s
    embeddings."""
    jmodel, variables, model = family(checked, backbone)
    crop = CROPS.get(backbone, (64, 32))
    sd = {"module." + k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in export_torch_state_dict(jmodel, variables,
                                              key_fn).items()}
    assert not any("q" in k for k in sd)
    sd["module.classifier.weight"] = torch.zeros(10, 2048)
    sd["module.classifier.bias"] = torch.zeros(10)
    sd["module.bn1.num_batches_tracked"] = torch.tensor(7)
    torch.save({"state_dict": sd}, tmp_path / "torchreid.pth")
    reid = OSNetReId(backbone=backbone, crop_size=crop,
                     checkpoint_path=str(tmp_path / "torchreid.pth"),
                     device="cpu")
    x = crops(crop, seed=3)
    reid._build()
    np.testing.assert_array_equal(reid._model(torch.from_numpy(x)).numpy(),
                                  model(torch.from_numpy(x)).numpy())
    sd["module.layerX.weight"] = torch.zeros(1)
    torch.save(sd, tmp_path / "extra.pth")
    with pytest.raises(ValueError, match="unused"):
        OSNetReId(backbone=backbone, crop_size=crop, device="cpu",
                  checkpoint_path=str(tmp_path / "extra.pth"))._build()


@pytest.fixture(scope="module")
def ibn_checkpoint(checked, tmp_path_factory):
    """resnet50_ibn_a's seeded flax variables (64 x 32) and the port's
    state dict of them."""
    _, variables, model = family(checked, "resnet50_ibn_a")
    path = tmp_path_factory.mktemp("zoo") / "ibn_a.pt"
    torch.save(model.state_dict(), path)
    return variables, path


def _as_jax_targets(node):
    if isinstance(node, dict):
        return {k: (v.replace("tracklab_torch.", "tracklab_tpu.")
                    if k == "_target_" else _as_jax_targets(v))
                for k, v in node.items() if k != "device"}
    if isinstance(node, list):
        return [_as_jax_targets(v) for v in node]
    return node


GT = ("state.load_from_groundtruth="
      "{detection: [bbox_ltwh, bbox_conf, category_id]}")
# GT boxes -> the config's resnet50_ibn_a at a 64 x 32 crop -> StrongSORT
# over its 2048-d features (capacities cut: the JAX scan's compile at
# strong_sort.yaml's 128 tracks x 100 features of 2048 takes ~80 s on a
# CPU)
ZOO = ["pipeline=[reid, track]", "+modules/reid=backbone_zoo",
       "modules.reid.crop_size=[64,32]", "modules.reid.batch_size=8",
       "modules/track=strong_sort", "modules.track.embed_dim=2048",
       "modules.track.max_tracks=16", "modules.track.max_dets=8",
       "modules.track.nn_budget=8",
       "dataset.n_videos=1", "dataset.n_frames=8", "dataset.n_objects=4",
       "dataset.img_w=256", "dataset.img_h=192", GT, "use_rich=false"]


def test_backbone_zoo_config_composes_as_in_jax():
    got = tcompose(TM.CONFIG_DIR, "config", ZOO)
    want = jcompose(JM.CONFIG_DIR, "config", ZOO)
    assert got["modules"]["reid"]["_target_"] == \
        "tracklab_torch.wrappers.reid.OSNetReId"
    assert got["modules"]["reid"]["backbone"] == "resnet50_ibn_a"
    assert _as_jax_targets(got) == {k: v for k, v in want.items()
                                    if k != "device"}


def test_backbone_zoo_cli_matches_jax(ibn_checkpoint):
    """``+modules/reid=backbone_zoo`` staged through both command lines on
    the same weights: ``OSNetReId(backbone="resnet50_ibn_a").process`` on
    the same host crops (parts and keypoint prompts off, the 2048-d global
    feature as ``embeddings`` within 1e-4 of its scale, visibility 1), then
    the same rows and track ids out of StrongSORT."""
    variables, path = ibn_checkpoint
    cfg = jcompose(JM.CONFIG_DIR, "config", ZOO)
    JM.init_environment(cfg)
    jparts = JM.build(cfg)
    jparts["modules"][0].variables = variables
    jparts["engine"].track_dataset()
    want = jparts["tracker_state"].detections_pred
    tparts, _ = TM.main(ZOO + [f"modules.reid.checkpoint_path={path}",
                               "device=cpu"])
    reid = tparts["modules"][0]
    assert isinstance(reid, OSNetReId) and reid.backbone == "resnet50_ibn_a"
    assert not reid.use_parts and not reid.use_keypoints
    assert reid.input_columns == ["bbox_ltwh"]
    got = tparts["tracker_state"].detections_pred
    pd.testing.assert_index_equal(got.index, want.index)
    emb = np.stack(want["embeddings"].to_numpy())
    assert emb.shape[1] == 2048
    close(np.stack(got["embeddings"].to_numpy()), emb)
    np.testing.assert_array_equal(
        np.stack(got["visibility_scores"].to_numpy()),
        np.ones((len(got), 1)))
    wv, gv = want["track_id"].notna(), got["track_id"].notna()
    assert wv.sum() > 0, "the tracker emitted nothing"
    np.testing.assert_array_equal(gv.to_numpy(), wv.to_numpy())
    np.testing.assert_array_equal(got.loc[gv, "track_id"].to_numpy(float),
                                  want.loc[wv, "track_id"].to_numpy(float))
