"""tracklab_torch OSNet and its crops vs the JAX package on the CPU.

OSNet x0_25 (with and without IBN) through ``osnet_from_flax`` against the
flax model in f32 on all three outputs, and one x1_0 crop at 256 x 128;
the torchreid key map and ``convert_osnet_torch`` on a state dict exported
from the flax tree; the port's ReID crop, ``crop_resize``, against the JAX
package's ``crop_resize_auto`` and ``crop_resize_onehot``. The flax variables are drawn from a seed
in the shapes of the model's tree, with norm statistics away from
identity.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from tracklab_tpu.models import convert as JC
from tracklab_tpu.models import preprocess as JP
from tracklab_tpu.models.osnet import OSNet as JOSNet
from tracklab_torch.models import preprocess as TP
from tracklab_torch.models.convert import (convert_osnet_torch,
                                           osnet_from_flax, osnet_torch_key)
from tracklab_torch.models.osnet import OSNet

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

KEYS = ("embeddings", "part_features", "visibility")


def _flax(variant, ibn, hw, seed, n_parts=6, feat_dim=512):
    """The flax OSNet and seeded variables of its tree's shapes (no init
    program is compiled): He-normal kernels, norm scales and variances in
    [0.5, 1.5], biases and means N(0, 0.1), so every norm layer does work.
    Returns (model, variables, jitted apply)."""
    jm = JOSNet(variant=variant, ibn=ibn, n_parts=n_parts, feat_dim=feat_dim)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + hw + (3,)), train=False))
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

    v = jax.tree_util.tree_map_with_path(draw, shapes)
    return jm, v, jax.jit(lambda v, x: jm.apply(v, x, train=False))


def _images(n, hw, seed):
    return np.random.default_rng(seed).normal(size=(n,) + hw + (3,)).astype(
        np.float32)


def _assert_outputs(got, want, atol):
    assert set(got) == set(KEYS)
    for k in KEYS:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape and got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("ibn", [False, True], ids=["plain", "ibn"])
def test_osnet_x0_25_matches_flax(ibn):
    hw = (128, 64)
    _, v, apply = _flax("x0_25", ibn, hw, seed=3 + ibn, n_parts=4,
                        feat_dim=64)
    x = _images(3, hw, seed=5)
    want = apply(v, jnp.asarray(x))
    tm = osnet_from_flax(v, n_parts=4, device="cpu")
    assert (tm.conv1.bn.__class__.__name__ == "_InstanceNorm") == ibn
    assert (tm.conv2[0].IN is not None) == ibn and tm.conv3[0].IN is None
    got = tm(torch.from_numpy(x))
    # f32, different summation orders through ~25 conv layers
    _assert_outputs(got, want, atol=1e-4 * float(
        np.abs(np.asarray(want["part_features"])).max()))


def test_osnet_x1_0_crop_matches_flax():
    hw = (256, 128)
    _, v, apply = _flax("x1_0", False, hw, seed=7)
    x = _images(1, hw, seed=8)
    want = apply(v, jnp.asarray(x))
    tm = osnet_from_flax(v, device="cpu")
    assert tm.fc[0].weight.shape == (512, 512)
    got = tm(torch.from_numpy(x))
    _assert_outputs(got, want, atol=1e-4 * float(
        np.abs(np.asarray(want["part_features"])).max()))


def test_torchreid_state_dict_loads():
    """The port's key map is the JAX package's; a torchreid-layout state
    dict (exported from the flax tree, with a DataParallel prefix, a
    classifier and BN counters) loads into OSNet and gives the flax
    model's global embeddings."""
    hw = (128, 64)
    jm, v, apply = _flax("x0_25", False, hw, seed=11, n_parts=4,
                         feat_dim=64)
    for path in flatten_dict(v):
        assert osnet_torch_key(path) == JC._osnet_torch_key(path), path
    sd = JC.export_torch_state_dict(jm, v, JC._osnet_torch_key)
    sd = {"module." + k: val for k, val in sd.items()}
    sd["module.classifier.weight"] = np.zeros((10, 64), np.float32)
    sd["module.conv1.bn.num_batches_tracked"] = np.zeros((), np.int64)
    tm = convert_osnet_torch(sd, OSNet("x0_25", 64, 4, device="cpu"))
    x = _images(2, hw, seed=12)
    want = np.asarray(apply(v, jnp.asarray(x))["embeddings"])
    got = tm(torch.from_numpy(x))["embeddings"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    del sd["module.conv5.bn.running_var"]
    with pytest.raises(ValueError):
        convert_osnet_torch(sd, OSNet("x0_25", 64, 4, device="cpu"))


def _crop_case(seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (3, 40, 56, 3)).astype(np.uint8)
    lt = rng.uniform(-10, 40, (3, 5, 2))
    wh = rng.uniform(2, 30, (3, 5, 2))
    boxes = np.concatenate([lt, lt + wh], -1).astype(np.float32)
    boxes[0, 0] = [0.3, 0.7, 0.3, 0.7]       # degenerate box
    return img, boxes


def test_crop_resize_matches_jax_crop_resize_auto():
    """The port's ReID crop (crop_resize, the exact gather) per frame
    against JAX's crop_resize_auto, which takes the same gather off a
    TPU."""
    img, boxes = _crop_case(0)
    got = TP.crop_resize(torch.from_numpy(img), torch.from_numpy(boxes),
                         24, 12)
    assert got.shape == (3, 5, 24, 12, 3) and got.dtype == torch.float32
    for f in range(3):
        want = np.asarray(JP.crop_resize_auto(jnp.asarray(img[f]),
                                              jnp.asarray(boxes[f]), 24, 12))
        # sample positions in f32 here, in f64 in JAX under x64
        np.testing.assert_allclose(got[f].numpy(), want, rtol=0, atol=2e-3)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_crop_resize_matches_jax_onehot(dtype):
    """The port's crop against JAX's one-hot contraction form (its crop on
    a TPU): the same bilinear samples, within the form's operand rounding
    (bf16: one ulp of 255 is 1.0, twice; f32: summation order only)."""
    img, boxes = _crop_case(1)
    got = TP.crop_resize(torch.from_numpy(img), torch.from_numpy(boxes),
                         16, 8)
    for f in range(3):
        want = np.asarray(JP.crop_resize_onehot(
            jnp.asarray(img[f]), jnp.asarray(boxes[f]), 16, 8,
            dtype=getattr(jnp, dtype)))
        np.testing.assert_allclose(got[f].numpy(), want, rtol=0,
                                   atol=2.0 if dtype == "bfloat16" else 1e-3)
