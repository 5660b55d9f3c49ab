"""The port's pitch-segmentation training loss (``models/segmentation.py:
seg_loss``) against the JAX package's on the CPU, value and gradient."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracklab_tpu.models.segmentation import seg_loss as jseg_loss
from tracklab_torch.models.segmentation import seg_loss

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)


@pytest.mark.parametrize("background_weight", [0.05, 1.0])
def test_seg_loss_and_gradient_match_jax(background_weight):
    """The class-weighted cross-entropy on a seeded (2, 12, 16, 5) logit map
    (background-heavy labels) and its gradient w.r.t. the logits, against
    JAX's ``seg_loss`` and ``jax.grad`` in float64: within 1e-12."""
    rng = np.random.default_rng(11)
    logits = rng.normal(0, 2, (2, 12, 16, 5))
    labels = np.where(rng.uniform(size=(2, 12, 16)) < 0.7, 0,
                      rng.integers(1, 5, (2, 12, 16))).astype(np.int32)
    want, want_g = jax.value_and_grad(
        lambda z: jseg_loss(z, jnp.asarray(labels), background_weight))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = seg_loss(x, torch.from_numpy(labels), background_weight)
    got.backward()
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-12)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-12)
