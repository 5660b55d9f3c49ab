"""tracklab_torch.ops.embeddings vs tracklab_tpu.ops.embeddings on seeded
numpy inputs in float64 (tests/conftest.py enables x64): normalisation,
cosine distances, the min-over-gallery distance with empty galleries, the
EMA and the gallery ring, also over a leading video axis."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracklab_tpu.ops import embeddings as J
from tracklab_torch.ops import embeddings as T

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

RTOL = 1e-12


def _np(x):
    return np.asarray(x)


def test_normalize_and_cosine_distance():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(6, 9)), rng.normal(size=(4, 9))
    a[2] = 0.0                                   # eps-clamped zero row
    np.testing.assert_allclose(T.normalize_rows(torch.from_numpy(a)).numpy(),
                               _np(J.normalize_rows(jnp.asarray(a))),
                               rtol=RTOL)
    for normalized in (False, True):
        got = T.cosine_distance_matrix(torch.from_numpy(a),
                                       torch.from_numpy(b), normalized)
        want = J.cosine_distance_matrix(jnp.asarray(a), jnp.asarray(b),
                                        normalized)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL,
                                   atol=1e-12)


@pytest.mark.parametrize("normalized", [True, False])
def test_nn_gallery_distance(normalized):
    rng = np.random.default_rng(1)
    g = rng.normal(size=(5, 7, 12))
    gv = rng.uniform(size=(5, 7)) < 0.6
    gv[3] = False                                # empty gallery -> 1e5
    f = rng.normal(size=(4, 12))
    if normalized:
        g = g / np.linalg.norm(g, axis=-1, keepdims=True)
        f = f / np.linalg.norm(f, axis=-1, keepdims=True)
    want = _np(J.nn_gallery_distance(jnp.asarray(g), jnp.asarray(gv),
                                     jnp.asarray(f), normalized))
    got = T.nn_gallery_distance(torch.from_numpy(g), torch.from_numpy(gv),
                                torch.from_numpy(f), normalized).numpy()
    assert (got[3] == 1e5).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)
    # a leading video axis: each video alone
    both = T.nn_gallery_distance(torch.from_numpy(np.stack([g, g[::-1]])),
                                 torch.from_numpy(np.stack([gv, gv[::-1]])),
                                 torch.from_numpy(np.stack([f, f])),
                                 normalized).numpy()
    np.testing.assert_allclose(both[0], got, rtol=RTOL)


def test_ema_update_and_gallery_push():
    rng = np.random.default_rng(2)
    T_, B, E = 6, 3, 8
    feat = rng.normal(size=(T_, E))
    feat /= np.linalg.norm(feat, axis=-1, keepdims=True)
    new = rng.normal(size=(T_, E))
    apply = rng.uniform(size=T_) < 0.5
    want = _np(J.ema_update(jnp.asarray(feat), jnp.asarray(new), 0.9,
                            jnp.asarray(apply)))
    got = T.ema_update(torch.from_numpy(feat), torch.from_numpy(new), 0.9,
                       torch.from_numpy(apply)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-15)

    gal = rng.normal(size=(T_, B, E))
    gv = rng.uniform(size=(T_, B)) < 0.5
    pos = rng.integers(0, 7, T_).astype(np.int32)    # wraps past B
    push = rng.uniform(size=T_) < 0.7
    jg, jv, jp = map(_np, J.gallery_push(*map(jnp.asarray,
                                              (gal, gv, pos, feat, push))))
    tg, tv, tp = (x.numpy() for x in T.gallery_push(
        *map(torch.from_numpy, (gal, gv, pos, feat, push))))
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tp, jp)
    assert tp.dtype == np.int32
