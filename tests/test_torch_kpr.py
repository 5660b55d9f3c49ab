"""tracklab_torch KPR (models/kpr.py, models/convert.kpr_from_flax,
models/preprocess.crop_resize) vs the JAX package on the CPU.

The JAX model is initialised once per module (the geometry of
test_kpr_parity.py: grid (4, 2), 5 parts, 7 prompt channels), its
parameters and BatchNorm statistics perturbed so no branch is trivial, and
converted into the port. Every output branch and the visibility must agree
in f32 to rtol 2e-4 / atol 2e-5 for each ``attn_impl`` (with and without
``token_pad``) and each ``gelu``: the two frameworks sum in other orders,
and LayerNorm's variance is computed by other formulas.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracklab_tpu.models import kpr as JK
from tracklab_tpu.models.preprocess import crop_resize as jax_crop_resize
from tracklab_torch.models import kpr as TK
from tracklab_torch.models.convert import kpr_from_flax
from tracklab_torch.models.preprocess import crop_resize

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

ARCH = dict(num_parts=5, dim_reduce_output=32, img_size=(64, 32),
            patch_size=16, stride=16, embed_dim=64, depth=2,
            num_heads=2, n_prompt_ch=7)
BRANCHES = ("globl", "foreg", "conct", "parts", "bn_globl", "bn_foreg",
            "bn_conct", "bn_parts", "pixels_cls_scores", "attn", "cls_feat")
RTOL, ATOL = 2e-4, 2e-5


def _perturbed(variables, rng):
    def leaf(path, x):
        x = np.asarray(x, np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x + rng.normal(0, 0.05, x.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 64, 32, 3)).astype(np.float32)
    p = rng.uniform(0, 1, (3, 64, 32, 7)).astype(np.float32)
    # jitted: one compile instead of one per op
    v = jax.jit(partial(JK.KPR(**ARCH).init, train=False))(
        jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(p))
    v = _perturbed(v, rng)
    # the SIE model's tree is the same plus backbone/sie_embed
    vs = jax.tree_util.tree_map(lambda a: a, v)
    vs["params"]["backbone"]["sie_embed"] = rng.normal(
        0, 0.05, (3, 1, ARCH["embed_dim"])).astype(np.float32)
    return x, p, v, vs


def _jax_apply(model, *args):
    """``model.apply(*args, train=False)``, jitted (one compile instead of
    one per op)."""
    return jax.jit(partial(model.apply, train=False))(*args)


def _port(variables, **kw):
    m = TK.KPR(device="cpu", **ARCH, **kw)
    m.load_state_dict(kpr_from_flax(variables), strict=True)
    return m


def _assert_outputs_match(got, want):
    for key in BRANCHES:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    for key in ("globl", "foreg", "conct", "parts"):
        np.testing.assert_allclose(got["visibility"][key].numpy(),
                                   np.asarray(want["visibility"][key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("attn_impl,token_pad,gelu", [
    *[(impl, 64, "erf") for impl in TK.ATTN_IMPLS],
    ("naive", 0, "erf"), ("dpa", 0, "tanh"), ("pallas", 0, "erfpoly"),
])
def test_kpr_matches_jax(data, attn_impl, token_pad, gelu):
    x, p, v, _ = data
    kw = dict(attn_impl=attn_impl, token_pad=token_pad, gelu=gelu)
    want = _jax_apply(JK.KPR(**ARCH, **kw), v, jnp.asarray(x),
                      jnp.asarray(p))
    got = _port(v, **kw)(torch.from_numpy(x), torch.from_numpy(p))
    _assert_outputs_match(got, want)
    je, jv = JK.extract_test_embeddings(want)
    te, tv = TK.extract_test_embeddings(got)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_kpr_sie_camera_and_no_prompt(data):
    x, _, _, vs = data
    cam = np.array([2, 0, 1], np.int32)
    want = _jax_apply(JK.KPR(n_cameras=3, **ARCH), vs, jnp.asarray(x), None,
                      jnp.asarray(cam))
    got = _port(vs, n_cameras=3)(torch.from_numpy(x), None,
                                 torch.from_numpy(cam))
    _assert_outputs_match(got, want)


def test_kpr_bf16_dtype_flow(data):
    """Each branch leaves the bf16 model in the JAX model's dtype (flax
    promotion: LayerNorm f32, Dense bf16, pixel softmax f32, BatchNorm
    bf16) and stays near it."""
    x, p, v, _ = data
    want = _jax_apply(JK.KPR(dtype=jnp.bfloat16, **ARCH), v,
                      jnp.asarray(x, jnp.bfloat16), jnp.asarray(p, jnp.bfloat16))
    got = _port(v, dtype=torch.bfloat16)(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(p).bfloat16())
    names = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
             jnp.dtype(jnp.float32): torch.float32}
    for key in BRANCHES:
        assert got[key].dtype == names[want[key].dtype], key
        np.testing.assert_allclose(got[key].float().numpy(),
                                   np.asarray(want[key], np.float32),
                                   rtol=0.1, atol=0.1, err_msg=key)


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("names", [("bn_foreg", "parts"),
                                   ("globl", "bn_parts", "conct")])
def test_extract_test_embeddings_matches_jax(names, binary):
    rng = np.random.default_rng(4)
    B, K, D = 3, 5, 8
    out = {n: rng.standard_normal((B, D)).astype(np.float32)
           for n in ("globl", "foreg", "conct", "bn_globl", "bn_foreg",
                     "bn_conct")}
    out.update({n: rng.standard_normal((B, K, D)).astype(np.float32)
                for n in ("parts", "bn_parts")})
    vis = {"globl": np.ones(B, np.float32),
           "foreg": rng.uniform(0, 1, B).astype(np.float32),
           "conct": np.ones(B, np.float32),
           "parts": rng.uniform(0, 1, (B, K)).astype(np.float32)}
    je, jv = JK.extract_test_embeddings(
        {**{k: jnp.asarray(a) for k, a in out.items()},
         "visibility": {k: jnp.asarray(a) for k, a in vis.items()}},
        names, binary)
    te, tv = TK.extract_test_embeddings(
        {**{k: torch.from_numpy(a) for k, a in out.items()},
         "visibility": {k: torch.from_numpy(a) for k, a in vis.items()}},
        names, binary)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_gaussian_prompt_maps_match_jax():
    rng = np.random.default_rng(6)
    box = np.array([[[10, 20, 60, 150], [100, 40, 130, 100]]], np.float32)
    kp = np.zeros((1, 2, 17, 3), np.float32)
    kp[..., 0] = rng.uniform(0, 140, (1, 2, 17))
    kp[..., 1] = rng.uniform(10, 160, (1, 2, 17))
    kp[..., 2] = rng.uniform(0, 1, (1, 2, 17))
    kp[0, 0, 3, 2] = 0.0                         # an invisible keypoint
    neg = kp[:, ::-1, :5].copy()
    for negative in (None, neg):
        want = jax.jit(JK.gaussian_prompt_maps, static_argnums=2)(
            jnp.asarray(kp), jnp.asarray(box), (32, 16),
            negative_kps=None if negative is None else jnp.asarray(negative))
        got = TK.gaussian_prompt_maps(
            torch.from_numpy(kp), torch.from_numpy(box), (32, 16),
            negative_kps=(None if negative is None
                          else torch.from_numpy(negative)))
        assert got.shape == (1, 2, 32, 16, 7)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def test_crop_resize_matches_jax_gather():
    """Random boxes over two frames, some partly outside the frame, some
    sub-pixel: the port's batched crop equals the JAX 4-tap gather per
    frame (pixel values 0-255, to 1e-3)."""
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (2, 48, 40, 3)).astype(np.uint8)
    lo = rng.uniform(-15, 35, (2, 6, 2))
    wh = rng.uniform(0.5, 30, (2, 6, 2))
    boxes = np.concatenate([lo, lo + wh], -1).astype(np.float32)
    got = crop_resize(torch.from_numpy(frames), torch.from_numpy(boxes),
                      16, 8)
    assert got.shape == (2, 6, 16, 8, 3) and got.dtype == torch.float32
    for f in range(2):
        want = np.asarray(jax_crop_resize(jnp.asarray(frames[f]),
                                          jnp.asarray(boxes[f]), 16, 8))
        np.testing.assert_allclose(got[f].numpy(), want, rtol=0, atol=1e-3)
    one = crop_resize(torch.from_numpy(frames[1]), torch.from_numpy(boxes[1]),
                      16, 8)
    torch.testing.assert_close(one, got[1], rtol=0, atol=0)
