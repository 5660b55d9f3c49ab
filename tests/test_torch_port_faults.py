"""The port's repairs against the JAX package on the CPU.

* The ORU replay: ``oru_replay_plain`` (the plain version of the ORU
  kernel) against JAX's ``XYSRFilter.oru_replay_batch`` on random gaps and
  flags, with gap 0 under need, need false and gap == max_age; and the
  masked loop to the largest gap equal to each slot replaying only its own
  gap, which is what the kernel does.
* The K3 route: K3 takes every layer the JAX kernel's
  ``csp_pallas_supported`` admits, for every CSPLayer of YOLOX s/m/l/x at
  640: ``choose_tile`` always gives a plan, a tile or the staged route.
* The attention mode: ``vit_attention_compute_plain`` (K4's
  compute-dtype mode, plain) against the JAX model's ``naive``, ``einsum`` and
  ``einsumT`` attention in bf16, and each port ``attn_impl`` picking the
  mode of its JAX lowering.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_csp import _yolox_csplayers
from tracklab_tpu.models import kpr as JK
from tracklab_tpu.ops.csp_pallas import csp_pallas_supported
from tracklab_tpu.ops.kalman import XYSRFilter as JKF
from tracklab_torch.kernels import csp as K3
from tracklab_torch.kernels.oru_replay import oru_replay, oru_replay_plain
from tracklab_torch.kernels.vit_attention import (
    vit_attention_compute_plain, vit_attention_plain)
from tracklab_torch.models import kpr as TK
from tracklab_torch.models.yolox import CSP_MAX_PIXELS
from tracklab_torch.ops.kalman import XYSRFilter as TKF

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

MAX_AGE = 12


def _oru_inputs(seed, shape=(3, 20)):
    """Random SPD covariances and positive boxes; gaps 0..MAX_AGE with 0
    and MAX_AGE forced under need, and need false on a fifth of slots."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=shape + (7, 7))
    P = A @ np.swapaxes(A, -1, -2) + 10 * np.eye(7)
    x = rng.uniform(1, 100, shape + (7,))
    zp = rng.uniform(1, 100, shape + (4,))
    zp[..., 3] = rng.uniform(0.3, 2.0, shape)
    zn = zp * rng.uniform(0.9, 1.1, shape + (4,))
    gap = rng.integers(0, MAX_AGE + 1, shape).astype(np.int32)
    need = rng.uniform(size=shape) < 0.8
    gap[..., 0], need[..., 0] = 0, True
    gap[..., 1], need[..., 1] = MAX_AGE, True
    need[..., 2] = False
    return x, P, zp, zn, gap, need


@pytest.mark.parametrize("seed", [0, 1])
def test_oru_replay_plain_matches_jax(seed):
    ins = _oru_inputs(seed)
    got = oru_replay_plain(*map(torch.from_numpy, ins))
    for v in range(ins[0].shape[0]):
        want = jax.jit(JKF.oru_replay_batch)(*(jnp.asarray(a[v])
                                               for a in ins))
        for g, w in zip(got, want):
            # float64 on both sides; the JAX batched matmuls sum in XLA's
            # order
            np.testing.assert_allclose(g[v].numpy(), np.asarray(w),
                                       rtol=1e-9, atol=1e-9)
    # slots without a replay keep the frozen state exactly
    keep = ~ins[5] | (ins[4] == 0)
    np.testing.assert_array_equal(got[0].numpy()[keep], ins[0][keep])
    np.testing.assert_array_equal(got[1].numpy()[keep], ins[1][keep])


def test_oru_replay_per_slot_equals_masked_loop():
    """The kernel replays each slot to its own gap; the masked loop runs
    all slots to the largest gap. The two agree slot for slot, and the
    filter's entry point and the wrapper run the plain version here."""
    ins = [torch.from_numpy(a) for a in _oru_inputs(2, shape=(2, 9))]
    x, P = oru_replay_plain(*ins)
    for v in range(2):
        for t in range(9):
            one = oru_replay_plain(*(a[v, t:t + 1] for a in ins))
            torch.testing.assert_close(one[0][0], x[v, t], rtol=0, atol=0)
            torch.testing.assert_close(one[1][0], P[v, t], rtol=0, atol=0)
    for fn in (oru_replay, TKF.oru_replay_batch):
        gx, gP = fn(*ins)
        assert torch.equal(gx, x) and torch.equal(gP, P)
    with pytest.raises(ValueError):
        oru_replay(ins[0], ins[1], ins[2][..., :3], *ins[3:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k3_takes_every_layer_the_jax_kernel_takes(dtype, monkeypatch):
    """The port sends a CUDA layer to K3 by the JAX kernel's shape rule
    (dense, H * W <= 80 * 80) and by nothing else, and choose_tile gives
    every such YOLOX s/m/l/x layer at 640 a plan: a tile whose buffers fit
    in shared memory, or the staged route."""
    monkeypatch.setenv("TRACKLAB_TPU_CSP_BACKEND", "pallas")
    assert CSP_MAX_PIXELS == 80 * 80
    for H, depthwise in ((80, False), (81, False), (40, True), (160, False)):
        assert csp_pallas_supported((1, H, H, 64), depthwise, None, False) \
            == (not depthwise and H * H <= CSP_MAX_PIXELS)
    for variant in ("s", "m", "l", "x"):
        for name, H, cin, ch, cout, n in _yolox_csplayers(variant, 640):
            assert csp_pallas_supported((2, H, H, cin), False, None, False)
            th, tw, ring = K3.choose_tile(H, H, n, cin, ch, cout, dtype)
            if ring == K3.STAGED:
                assert (th, tw) == (H, H), (variant, name)
            else:
                assert K3.smem_bytes(th, tw, n, ch, ring) \
                    <= K3.SMEM_LIMIT, (variant, name)


def test_yolox_l_x_layers_without_a_tile_take_the_staged_route():
    """dark4 of YOLOX-l and dark3/dark4 of YOLOX-x fit no bf16 tile: K3
    runs them by the staged route; every other YOLOX-l/x layer at 640
    takes a tile."""
    staged = set()
    for variant in ("l", "x"):
        for name, H, cin, ch, cout, n in _yolox_csplayers(variant, 640):
            plan = K3.choose_tile(H, H, n, cin, ch, cout, torch.bfloat16)
            if plan[2] == K3.STAGED:
                staged.add((variant, name))
    assert staged == {("l", "dark4"), ("x", "dark3"), ("x", "dark4")}


def _jax_attention(impl, dim, heads, x, key_valid):
    m = JK._Attention(dim, heads, dtype=jnp.bfloat16, impl=impl)
    v = m.init(jax.random.PRNGKey(0), jnp.zeros((1,) + x.shape[1:]))
    y = m.apply(v, jnp.asarray(x), key_valid)
    return v["params"], np.asarray(y.astype(jnp.float32))


def _torch_attention(impl, dim, heads, params, n_valid):
    m = TK._Attention(dim, heads, torch.bfloat16, impl, n_valid)
    with torch.no_grad():
        for name in ("qkv", "proj"):
            lin = getattr(m, name)
            lin.weight.copy_(torch.from_numpy(
                np.asarray(params[name]["kernel"]).T.copy()))
            lin.bias.copy_(torch.from_numpy(np.array(params[name]["bias"])))
    return m


@pytest.mark.parametrize("n_valid", [None, 13])
@pytest.mark.parametrize("impl", ["naive", "einsum", "einsumT"])
def test_compute_dtype_attention_matches_jax_bf16(impl, n_valid):
    """The port's attention for a compute-dtype impl is the bf16 softmax of
    the JAX lowering: within a few bf16 ulps of it (XLA and torch round
    the logits' sums in their own orders), and nearer to it than the f32
    softmax is."""
    B, N, dim, heads = 3, 17, 64, 4
    x = np.random.default_rng(5).normal(size=(B, N, dim)).astype(np.float32)
    key_valid = None if n_valid is None else jnp.arange(N) < n_valid
    params, want = _jax_attention(impl, dim, heads, x, key_valid)
    m = _torch_attention(impl, dim, heads, params, n_valid)
    assert m.softmax == "compute"
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got = m(xt).float().numpy()
        q, k, v = m.qkv(xt).reshape(B, N, 3, heads, -1).unbind(2)
        direct = vit_attention_compute_plain(q, k, v, n_valid)
        f32_softmax = m.proj(vit_attention_plain(q, k, v, n_valid).reshape(
            B, N, dim)).float().numpy()
    assert direct.dtype == torch.bfloat16
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= 2e-2 * scale, (err, scale)
    assert np.abs(got - want).mean() < np.abs(f32_softmax - want).mean()


@pytest.mark.parametrize("impl", TK.ATTN_IMPLS)
def test_attn_impl_picks_its_softmax_mode(impl):
    m = TK._Attention(32, 2, torch.bfloat16, impl)
    assert m.softmax == ("f32" if impl in ("dpa", "pallas") else "compute")
