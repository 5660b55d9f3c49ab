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
from tracklab_torch.kernels.vit_attention import (vit_attention,
                                                  vit_attention_plain)

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
