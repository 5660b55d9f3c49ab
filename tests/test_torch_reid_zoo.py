"""The port's ReID backbone zoo against the JAX package's, on the CPU.

Each family of ``OSNetReId(backbone=...)`` through ``reid_backbone_from_flax``:
the same seeded numpy crops (batch 2, normalised, 64 x 32; HACNN at its
fixed 160 x 64, MuDeep at 256 x 128, the Inception families at 96 x 80, the
least that leaves their last reduction an input) through JAX's jitted
``apply`` and the port, the features within 1e-4 of their scale (f32).
The ResNet, MobileNetV2 and ShuffleNetV2 variants that change only depths
or widths of a family checked here (resnet34, resnet101, resnet152,
resnext101_32x8d, mobilenetv2_x1_4, shufflenet_v2_x0_5/x1_5/x2_0) are held
by their trees: the JAX package's tree of the variant loads strict into the
port's model of the same key, which then gives features of the width JAX's
model defines (the family's forward is the same code).

The JAX variables are seeded numpy draws on the flax tree's shapes:
kernels uniform with lecun's spread (std sqrt(1 / fan_in)), norm scales and
variances in [0.5, 1.5], other leaves uniform with std 0.1. The shapes are
``jax.eval_shape`` of each key's flax init, kept in
``tests/data/reid_zoo_flax_shapes.json.gz`` (``PYTHONPATH=. python
tests/test_torch_reid_zoo.py`` writes it): an eval_shape of these models
costs as much as the JAX forward's own trace (2-5 s each on a CPU), and
flax's apply checks every parameter's shape, so a stale file fails the
families.
The rest of the families and the wrapper, weights and config tests are in
``test_torch_reid_zoo_wrapper.py`` (two files, so that the suite's
``--dist loadfile`` spreads them over two workers).
"""
import gzip
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracklab_tpu.wrappers.reid.osnet_api import (
    select_backbone_model as jax_select)
from tracklab_torch.models.convert import reid_backbone_from_flax

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

CROP = (64, 32)
# fixed inputs, and the least crop the Inception families take
CROPS = {"hacnn": (160, 64), "mudeep": (256, 128),
         "inceptionv4": (96, 80), "inceptionresnetv2": (96, 80)}
REL = 1e-4
FAMILIES = ("resnet18", "resnet50", "resnet50_fc512", "resnext50_32x4d",
            "mobilenetv2_x1_0", "shufflenet_v2_x1_0", "se_resnet50",
            "resnet50mid", "pcb_p6", "densenet121", "squeezenet1_0", "mlfn",
            "xception")
VARIANTS = {"resnet34": 512, "resnet101": 2048, "resnet152": 2048,
            "resnext101_32x8d": 2048, "mobilenetv2_x1_4": 1792,
            "shufflenet_v2_x0_5": 1024, "shufflenet_v2_x1_5": 1024,
            "shufflenet_v2_x2_0": 2048}
# test_torch_reid_zoo_wrapper.py's families
OTHER_FAMILIES = ("resnet50_ibn_a", "resnet50_ibn_b", "osnet_ain_x1_0",
                  "hacnn", "mudeep", "inceptionv4", "inceptionresnetv2",
                  "nasnetamobile")
# the variables' shapes of every key above, from jax.eval_shape of its flax
# init (written by running this file); a wrong or stale shape fails the
# JAX apply (flax checks each parameter's shape) and the port's strict load
SHAPES = Path(__file__).parent / "data" / "reid_zoo_flax_shapes.json.gz"


def _eval_shapes(backbone):
    """``jax.eval_shape`` of the flax init of ``backbone`` at its crop."""
    model = jax_select(backbone, crop_size=CROPS.get(backbone, CROP))
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros(
            (1,) + CROPS.get(backbone, CROP) + (3,), jnp.float32),
        train=False))


def write_shapes():
    """Write SHAPES: each key's variables as {"collection/module/.../leaf":
    shape}."""
    out = {}
    for backbone in FAMILIES + tuple(VARIANTS) + OTHER_FAMILIES:
        flat = jax.tree_util.tree_flatten_with_path(_eval_shapes(backbone))
        out[backbone] = {"/".join(k.key for k in path): list(a.shape)
                         for path, a in flat[0]}
    SHAPES.parent.mkdir(exist_ok=True)
    with gzip.open(SHAPES, "wt") as f:
        json.dump(out, f, sort_keys=True, separators=(",", ":"))


def flax_shapes(backbone, crop):
    """The flax model of ``backbone`` and its variables' shapes (SHAPES: the
    tree of ``jax.eval_shape``, which costs as much as the JAX forward's own
    trace, read from the file written by ``write_shapes``)."""
    with gzip.open(SHAPES, "rt") as f:
        leaves = json.load(f)[backbone]
    tree = {}
    for key, shape in leaves.items():
        *parents, leaf = key.split("/")
        node = tree
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = jax.ShapeDtypeStruct(tuple(shape), jnp.float32)
    return jax_select(backbone, crop_size=crop), tree


def flax_variables(backbone, crop, seed=0):
    """Seeded numpy variables on the flax tree of ``backbone``."""
    model, shapes = flax_shapes(backbone, crop)
    rng = np.random.default_rng(seed)

    def draw(path, a):
        # uniform draws of the stated spread (a uniform on [-h, h] has
        # std h / sqrt(3)): numpy's normals of MuDeep's 134M-weight fc
        # take ~4 s
        name = path[-1].key
        if name == "kernel":
            std = np.sqrt(1.0 / int(np.prod(a.shape[:-1])))
        elif name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        else:
            std = 0.1
        u = rng.random(a.shape, np.float32)
        return (u - np.float32(0.5)) * np.float32(2 * np.sqrt(3) * std)

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


def crops(crop, batch=2, seed=1):
    return np.random.default_rng(seed).normal(
        0, 1, (batch,) + crop + (3,)).astype(np.float32)


def jax_features(model, variables, x):
    """JAX's jitted ``apply``, compiled at XLA's backend optimisation level
    0 (the same program; the default level's compile is 1.5-2x longer)."""
    fn = jax.jit(lambda v, x: model.apply(v, x, train=False))
    return np.asarray(fn.lower(variables, x).compile(compiler_options={
        "xla_backend_optimization_level": 0})(variables, x))


def close(got, want, rel=REL):
    want = np.asarray(want)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max())


def check_family(backbone):
    """``backbone`` through both packages on the same weights and crops."""
    crop = CROPS.get(backbone, CROP)
    jmodel, variables = flax_variables(backbone, crop)
    x = crops(crop)
    want = jax_features(jmodel, variables, x)
    model = reid_backbone_from_flax(variables, backbone, crop_size=crop,
                                    device="cpu")
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    close(got.numpy(), want)
    return jmodel, variables, model


@pytest.mark.parametrize("backbone", FAMILIES)
def test_family_matches_jax(backbone):
    """ResNet (BasicBlock, Bottleneck, the fc512 head at last stride 1,
    ResNeXt's groups), MobileNetV2, ShuffleNetV2, SE-ResNet50,
    ResNet50-mid, PCB, DenseNet121, SqueezeNet 1.0 (ceil-mode pools), MLFN
    and Xception."""
    check_family(backbone)


@pytest.mark.parametrize("backbone,dim", VARIANTS.items())
def test_variant_tree_matches_jax(backbone, dim):
    """A variant's depths and widths: JAX's tree (zeros) loads strict into
    the port's model of the key (any missing, unused or misshaped tensor
    raises), whose features are ``dim`` wide, JAX's width for the key."""
    _, shapes = flax_shapes(backbone, CROP)
    zeros = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), shapes)
    model = reid_backbone_from_flax(zeros, backbone, device="cpu")
    assert model(torch.from_numpy(crops(CROP))).shape == (2, dim)


def test_shapes_file_holds_jax_trees():
    """SHAPES against ``jax.eval_shape`` for the config's resnet50_ibn_a
    (the families' forwards check the rest through flax's shape checks)."""
    flat = jax.tree_util.tree_flatten_with_path(
        _eval_shapes("resnet50_ibn_a"))[0]
    want = {"/".join(k.key for k in path): tuple(a.shape) for path, a in flat}
    got = jax.tree_util.tree_flatten_with_path(
        flax_shapes("resnet50_ibn_a", CROP)[1])[0]
    assert {"/".join(k.key for k in path): a.shape
            for path, a in got} == want


if __name__ == "__main__":
    write_shapes()
