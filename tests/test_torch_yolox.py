"""tracklab_torch YOLOX, weight conversion and NMS vs the JAX package on
the CPU (f32, small variants and sizes)."""
import functools

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from tracklab_tpu.models.convert import export_torch_state_dict
from tracklab_tpu.models.yolox import YOLOX as JYOLOX
from tracklab_tpu.ops import nms as JN
from tracklab_torch.models.convert import yolox_from_flax
from tracklab_torch.models.yolox import YOLOX
from tracklab_torch.ops import nms as TN

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _flax_yolox(variant, size):
    """Flax YOLOX with seeded numpy weights: the init's tree structure
    (from ``jax.eval_shape``, no compile), lecun-normal conv kernels, small
    biases and random BN statistics (the regime of trained checkpoints), as
    numpy trees."""
    model = JYOLOX(num_classes=2, variant=variant)
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(3)

    def draw(leaf):
        if len(leaf.shape) == 1:
            return np.abs(rng.normal(size=leaf.shape)) * 0.3 + 0.5
        fan_in = int(np.prod(leaf.shape[:-1]))
        return rng.normal(size=leaf.shape) / np.sqrt(fan_in)

    v = jtu.tree_map(lambda leaf: np.asarray(draw(leaf), np.float32), shapes)
    return model, v


@pytest.mark.parametrize("variant", ["tiny", "nano"])
def test_convert_matches_export_and_loads_strict(variant):
    model, v = _flax_yolox(variant, 64)
    sd = yolox_from_flax(v)
    want = export_torch_state_dict(model, v)
    assert set(sd) == set(want)
    for k, t in sd.items():
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)
    tm = YOLOX(num_classes=2, variant=variant, device="cpu")
    assert set(tm.state_dict()) == set(sd)
    tm.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("variant,size", [("tiny", 64), ("nano", 64)])
def test_predict_matches_jax(variant, size):
    model, v = _flax_yolox(variant, size)
    x = np.random.default_rng(0).uniform(0, 255, (2, size, size, 3)) \
        .astype(np.float32)
    want = np.asarray(jax.jit(lambda i: model.apply(
        v, i, method=JYOLOX.predict))(jnp.asarray(x)))
    tm = YOLOX(num_classes=2, variant=variant, device="cpu")
    tm.load_state_dict(yolox_from_flax(v), strict=True)
    got = tm.predict(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    rel = (np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max()
    assert rel < 1e-4, rel


def test_randomize_is_seeded():
    a = YOLOX(num_classes=1, variant="nano", device="cpu").randomize_(5)
    b = YOLOX(num_classes=1, variant="nano", device="cpu").randomize_(5)
    for (k, ta), tb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(ta, tb), k


def _decoded_with_ties(seed, B=2, A=300, C=2):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(20, 200, (B, A, 2))
    # boxes on a coarse grid so many overlap exactly
    xy = np.round(xy / 20) * 20
    wh = rng.choice([20.0, 30.0, 40.0], (B, A, 2))
    obj = rng.choice([0.9, 0.8, 0.5, 0.05], (B, A, 1))
    cls = rng.choice([0.9, 0.6, 0.3], (B, A, C))
    return np.concatenate([xy, wh, obj, cls], axis=-1).astype(np.float32)


@pytest.mark.parametrize("class_agnostic", [True, False])
def test_postprocess_matches_jax_with_ties(class_agnostic):
    d = _decoded_with_ties(1)
    want = jax.jit(functools.partial(
        JN.postprocess_detections, conf_threshold=0.2, iou_threshold=0.5,
        max_out=16, class_agnostic=class_agnostic))(jnp.asarray(d))
    got = TN.postprocess_detections(torch.from_numpy(d), conf_threshold=0.2,
                                    iou_threshold=0.5, max_out=16,
                                    class_agnostic=class_agnostic)
    for k in ("valid", "cls", "ltrb", "score"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert got["cls"].dtype == torch.int32


def test_nms_keep_mask_matches_jax():
    rng = np.random.default_rng(4)
    b = np.round(rng.uniform(0, 100, (40, 2)) / 10) * 10
    ltrb = np.concatenate([b, b + 30], 1).astype(np.float32)
    scores = rng.choice([0.9, 0.7, 0.7, 0.4, 0.0], 40).astype(np.float32)
    want = np.asarray(jax.jit(JN.nms, static_argnums=(2, 3))(
        jnp.asarray(ltrb), jnp.asarray(scores), 0.5, 8))
    got = TN.nms(torch.from_numpy(ltrb), torch.from_numpy(scores), 0.5, 8)
    np.testing.assert_array_equal(got.numpy(), want)
