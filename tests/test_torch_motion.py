"""tracklab_torch global motion estimation vs the JAX package on the CPU:
the dense pyramidal LK (``motion/lk.py`` against ``motion/lk_jax.py`` and
``parallel/time_shard.py:gmc_warps_time_sharded`` on one device) and the
host ``GMC`` (``motion/gmc.py``) in its "lk_jax", "file" and "none" modes.

The port runs in f32; the JAX estimator runs partly in float64 under x64
(its parameters), so warps are held within 1e-3 absolute. Warps are also
held to the motion they should recover, as tests/test_motion.py does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch
from jax.sharding import Mesh

from test_motion import smooth_random_image
from tracklab_tpu.motion import gmc as JG
from tracklab_tpu.motion import lk_jax as JL
from tracklab_tpu.parallel.time_shard import gmc_warps_time_sharded
from tracklab_torch.motion import gmc as TG
from tracklab_torch.motion import lk as TL

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)


def _pairs():
    """{name: (prev, cur, expected warp)}: a shift by (-2, 3) and a
    1-degree rotation about the centre of a smooth 128 x 160 image."""
    rng = np.random.default_rng(0)
    base = smooth_random_image(rng)
    shifted = ndi.shift(base, (-2, 3), order=1).astype(np.float32)
    rng = np.random.default_rng(1)
    base2 = smooth_random_image(rng)
    rotated = ndi.rotate(base2, 1.0, reshape=False, order=1).astype(
        np.float32)
    th = np.deg2rad(1.0)
    R = np.array([[np.cos(th), np.sin(th)], [-np.sin(th), np.cos(th)]])
    return {"shift": (base, shifted, np.array([[1.0, 0, 3], [0, 1, -2]])),
            "rotation": (base2, rotated, np.column_stack([R, [np.nan] * 2]))}


@pytest.fixture(scope="module")
def pairs():
    """Each pair with the JAX estimate."""
    return {k: (p, c, w, np.asarray(JL.estimate_affine_lk(jnp.asarray(p),
                                                          jnp.asarray(c))))
            for k, (p, c, w) in _pairs().items()}


@pytest.mark.parametrize("name", ["shift", "rotation"])
def test_estimate_affine_lk_matches_jax(pairs, name):
    """Within 1e-3 of JAX, and the motion recovered: the shift within 0.15
    px with the linear part within 0.01 of the identity; the rotation's
    linear part within 0.02 (tests/test_motion.py's bounds)."""
    prev, cur, expect, want = pairs[name]
    got = TL.estimate_affine_lk(torch.from_numpy(prev),
                                torch.from_numpy(cur)).numpy()
    assert got.shape == (2, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-3)
    if name == "shift":
        np.testing.assert_allclose(got[:, 2], expect[:, 2], atol=0.15)
        np.testing.assert_allclose(got[:, :2], np.eye(2), atol=0.01)
    else:
        np.testing.assert_allclose(got[:, :2], expect[:, :2], atol=0.02)


def test_lk_parts_match_jax():
    """torch.gradient equals jnp.gradient (edge order 1) bit for bit in
    f32; warp_affine (samples and mask), the grayscale and the 2x2
    downscale within 1e-4 of JAX; a batch of pairs equals the pairs one by
    one within 1e-5."""
    rng = np.random.default_rng(2)
    img = smooth_random_image(rng, 48, 56)
    gy, gx = torch.gradient(torch.from_numpy(img), dim=(-2, -1))
    jgy, jgx = jnp.gradient(jnp.asarray(img))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(jgy))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jgx))
    warp = np.array([[1.01, 0.02, 1.5], [-0.01, 0.99, -2.25]], np.float32)
    s, m = TL.warp_affine(torch.from_numpy(img), torch.from_numpy(warp))
    js, jm = JL.warp_affine(jnp.asarray(img), jnp.asarray(warp))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-4)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    rgb = rng.uniform(0, 255, (9, 11, 3)).astype(np.float32)
    np.testing.assert_allclose(
        TL._grayscale(torch.from_numpy(rgb)).numpy(),
        np.asarray(JL._grayscale(jnp.asarray(rgb))), atol=1e-4)
    np.testing.assert_allclose(
        TL._downscale2(torch.from_numpy(img[:47])).numpy(),
        np.asarray(JL._downscale2(jnp.asarray(img[:47]))), atol=1e-4)
    prev = np.stack([smooth_random_image(rng, 48, 56) for _ in range(3)])
    cur = np.stack([ndi.shift(p, (1, -1), order=1) for p in prev])
    batch = TL.estimate_affine_lk(torch.from_numpy(prev),
                                  torch.from_numpy(cur.astype(np.float32)))
    for i in range(3):
        one = TL.estimate_affine_lk(torch.from_numpy(prev[i]),
                                    torch.from_numpy(cur[i].astype(
                                        np.float32)))
        np.testing.assert_allclose(batch[i].numpy(), one.numpy(), atol=1e-5)


def _panning_video(n=6, h=96, w=128, drift=(2.0, -1.0)):
    """n uint8 RGB frames cut from one smooth texture panning by ``drift``
    (x, y) px per frame: warp[t] should be a translation by -drift."""
    rng = np.random.default_rng(3)
    tex = smooth_random_image(rng, h + 64, w + 64)
    frames = [ndi.shift(tex, (-drift[1] * t, -drift[0] * t), order=1)
              [32:32 + h, 32:32 + w] for t in range(n)]
    return np.stack([np.stack([f] * 3, -1) for f in frames]).astype(
        np.uint8)


def test_gmc_warps_matches_jax_time_sharded():
    """gmc_warps over a panning RGB video against the JAX time-sharded
    estimator on a one-device mesh, within 1e-3; warp[0] is the identity
    and the others translate by the pan within 0.25 px; with ``prev`` the
    first warp is estimated too."""
    video = _panning_video()
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    want = np.asarray(gmc_warps_time_sharded(mesh)(jnp.asarray(video)))
    got = TL.gmc_warps(torch.from_numpy(video)).numpy()
    assert got.shape == (len(video), 2, 3)
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_array_equal(got[0], np.eye(2, 3))
    np.testing.assert_allclose(got[1:, :, 2], np.tile([-2.0, 1.0], (5, 1)),
                               atol=0.25)
    np.testing.assert_allclose(got[1:, :, :2],
                               np.broadcast_to(np.eye(2), (5, 2, 2)),
                               atol=0.01)
    tail = TL.gmc_warps(torch.from_numpy(video[3:]),
                        prev=torch.from_numpy(video[2])).numpy()
    np.testing.assert_allclose(tail, got[3:], atol=1e-5)


@pytest.mark.parametrize("method", ["lk_jax", "file", "none"])
def test_gmc_matches_jax(method, tmp_path):
    """The host GMC against JAX's on the same frames: "lk_jax" (OpenCV
    prep, the dense LK on the CPU here) within 1e-3, "file" and "none"
    exactly, the identity on the first frame."""
    rng = np.random.default_rng(3)
    base = smooth_random_image(rng, 240, 320)
    prev = np.stack([base] * 3, -1).astype(np.uint8)
    cur = np.stack([ndi.shift(base, (4, -6), order=1)] * 3, -1).astype(
        np.uint8)
    kw = {}
    if method == "file":
        path = tmp_path / "GMC-seq.txt"
        path.write_text("0\t1.0\t0.0\t2.5\t0.0\t1.0\t-1.5\n"
                        "1 0.99 0.01 3.0 -0.01 0.99 1.0\n")
        kw = dict(gmc_file_dir=str(tmp_path), seq_name="seq-FRCNN")
    j = JG.GMC(method, downscale=2, **kw)
    t = TG.GMC(method, downscale=2, device="cpu", **kw)
    for p, c in ((None, prev), (prev, cur), (cur, cur)):
        want, got = j.apply(p, c), t.apply(p, c)
        assert got.dtype == np.float32 and got.shape == (2, 3)
        np.testing.assert_allclose(got, want, atol=1e-3 if method == "lk_jax"
                                   else 0.0)
    if method == "lk_jax":
        np.testing.assert_allclose(t.apply(prev, cur)[:, 2], [-6.0, 4.0],
                                   atol=1.0)
    t.reset()
    j.reset()
    np.testing.assert_array_equal(t.apply(None, prev), j.apply(None, prev))
    t.close()
    j.close()
