"""K4's plain version (``vit_attention_plain``) vs the JAX package's Pallas
ViT attention kernel in interpret mode on the CPU, and the wrapper's CPU
dispatch. The CUDA kernel itself is held against the plain version on the
card by chip_smoke.py.

Tolerances: f32 1e-5 abs (both take f32 scores and an f32 softmax; only
the summation order differs). bf16 2e-2 abs on outputs of order 1: the
probabilities are rounded to bf16 before the product with v, so one bf16
ulp of a probability may land on either side.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracklab_tpu.ops.vit_attention_pallas import vit_attention as jax_vit
from tracklab_torch.kernels.vit_attention import (MAX_HEAD_DIM, MAX_TOKENS,
                                                  _aligned, route,
                                                  vit_attention,
                                                  vit_attention_plain)

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)

CASES = [((3, 33, 4, 16), None), ((2, 40, 4, 16), 20)]
TOL = {"f32": 1e-5, "bf16": 2e-2}
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape,n_valid", CASES)
def test_plain_matches_jax_interpret(shape, n_valid, dt):
    jdt, tdt = _DT[dt]
    q, k, v = _qkv(shape, seed=sum(shape))
    want = jax_vit(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                   n_valid=n_valid, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = vit_attention_plain(*(torch.from_numpy(a).to(tdt)
                                for a in (q, k, v)), n_valid)
    assert got.dtype == tdt and tuple(got.shape) == shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=TOL[dt])


def test_masked_keys_do_not_matter():
    """Keys at or past n_valid carry no weight: changing them leaves the
    output unchanged."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 40, 4, 16), seed=3))
    base = vit_attention_plain(q, k, v, 20)
    k2, v2 = k.clone(), v.clone()
    k2[:, 20:] = 1e3
    v2[:, 20:] = -7.0
    torch.testing.assert_close(vit_attention_plain(q, k2, v2, 20), base,
                               rtol=0, atol=0)


def test_wrapper_runs_plain_on_cpu_and_checks_shapes():
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 9, 3, 8), seed=5))
    before = vit_attention.launches
    got = vit_attention(q, k, v)
    assert vit_attention.launches == before        # counts card launches
    torch.testing.assert_close(got, vit_attention_plain(q, k, v), rtol=0,
                               atol=0)
    # the q, k, v views of one packed qkv tensor are taken as they are
    qkv = torch.randn(2, 9, 3, 3, 8)
    q, k, v = qkv.unbind(2)
    torch.testing.assert_close(vit_attention(q, k, v, 5),
                               vit_attention_plain(q.contiguous(),
                                                   k.contiguous(),
                                                   v.contiguous(), 5))
    with pytest.raises(ValueError):
        vit_attention(q, k[:, :4], v)
    with pytest.raises(ValueError):
        vit_attention(q, k, v, n_valid=0)


def test_route_by_dtype_and_shape():
    """bf16 runs the bf16 kernel and needs Dh % 16 == 0; f32 runs the
    3xTF32 kernel (both on the tensor cores), which needs its staged K and
    V in shared memory; shapes neither takes raise, with no fallback."""
    assert route(torch.bfloat16, 193, 64) == "tl_vit_attention_bf16_mma"
    assert route(torch.bfloat16, 256, 128) == "tl_vit_attention_bf16_mma"
    assert route(torch.float32, 193, 64) == "tl_vit_attention_f32"
    assert route(torch.float32, 37, 24) == "tl_vit_attention_f32"
    for N, Dh in [(193, 24), (193, 8), (50, 72)]:
        with pytest.raises(ValueError):
            route(torch.bfloat16, N, Dh)
    for dt in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError):
            route(dt, MAX_TOKENS + 1, 64)
        with pytest.raises(ValueError):
            route(dt, 193, MAX_HEAD_DIM + 16)
    with pytest.raises(TypeError):
        route(torch.float16, 193, 64)
    # f32: K and V of 256 keys at Dh 128 exceed shared memory
    with pytest.raises(ValueError):
        route(torch.float32, 256, 128)


def test_packed_qkv_views_are_read_in_place():
    """The q, k, v slices of a packed bf16 qkv tensor start every row on 16
    bytes, so the tensor-core kernel's 16-byte copies read them in place; a
    view that does not is copied first."""
    qkv = torch.zeros(2, 193, 3, 12, 64, dtype=torch.bfloat16)
    assert all(_aligned(a) for a in qkv.unbind(2))
    odd = torch.zeros(2, 9, 3, 3, 20, dtype=torch.bfloat16).unbind(2)[1]
    assert not _aligned(odd)                 # head stride 20: 40 bytes
    assert _aligned(odd.float())             # f32 needs only stride(3) == 1
    assert not _aligned(qkv.unbind(2)[0].transpose(2, 3))


def test_division_step_matches_ieee_division():
    """K4 divides by the row sum as q = e * r, q + (e - q d) r with
    r = RN(1 / d) (one residual correction, each step rounded to f32, the
    residual exact as an FMA). For the kernel's range (0 <= e <= 1 <= d <=
    256) this is the correctly rounded e / d."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    d = rng.uniform(1.0, 256.0, 200000).astype(f32)
    e = rng.uniform(0.0, 1.0, 200000).astype(f32) * \
        rng.choice([1.0, 1e-3, 1e-9, 1e-30], 200000).astype(f32)
    r = (f32(1.0) / d).astype(f32)
    q = (e * r).astype(f32)
    # an FMA's residual is exact: compute it in float64, round once
    res = (e.astype(np.float64) - q.astype(np.float64) * d).astype(f32)
    got = (res.astype(np.float64) * r + q).astype(f32)
    np.testing.assert_array_equal(got, (e / d).astype(f32))
