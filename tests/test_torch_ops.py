"""tracklab_torch boxes and assignment vs the JAX package on the CPU.

The same numpy inputs go through both; the JV solver and the forced
matching must give identical assignments, ties included (the port follows
``_solve_square_lax``'s step order and lowest-index argmin)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from tracklab_tpu.ops import assignment as JA
from tracklab_tpu.ops import boxes as JB
from tracklab_torch.kernels.jv import solve_square_batched
from tracklab_torch.ops import assignment as TA
from tracklab_torch.ops import boxes as TB

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)


def _boxes(rng, n):
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(5, 80, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1)


@pytest.mark.parametrize("name", ["iou_matrix", "pairwise_iou", "giou_matrix",
                                  "diou_matrix", "ciou_matrix"])
def test_pairwise_matrices_match_jax(name):
    rng = np.random.default_rng(0)
    b1, b2 = _boxes(rng, 7), _boxes(rng, 5)
    b2[0] = b1[0]                       # an exact overlap
    want = np.asarray(getattr(JB, name)(jnp.asarray(b1), jnp.asarray(b2)))
    got = getattr(TB, name)(torch.from_numpy(b1), torch.from_numpy(b2))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["xywh_to_ltrb", "ltrb_to_xysr"])
def test_box_formats_match_jax(name):
    b = _boxes(np.random.default_rng(1), 9)
    want = np.asarray(getattr(JB, name)(jnp.asarray(b)))
    got = getattr(TB, name)(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    back = TB.xysr_to_ltrb(TB.ltrb_to_xysr(torch.from_numpy(b))).numpy()
    jback = np.asarray(JB.xysr_to_ltrb(JB.ltrb_to_xysr(jnp.asarray(b))))
    np.testing.assert_allclose(back, jback, rtol=1e-6, atol=1e-6)


_lax_solve = jax.jit(JA._solve_square_lax)
_jax_forced = jax.jit(JA.matching_forced)


def _tie_matrices():
    k = 16
    c = np.zeros((k, k), np.float32)
    c[:5, :4] = -2.0          # the matching_forced absorbing structure
    rng = np.random.default_rng(5)
    return [c, rng.integers(0, 3, (8, 8)).astype(np.float32),
            np.ones((6, 6), np.float32)]


@pytest.mark.parametrize("k", [4, 16, 33, 64])
def test_solve_square_plain_identical_to_lax(k):
    rng = np.random.default_rng(k)
    for _ in range(2):
        c = rng.normal(size=(k, k)).astype(np.float32)
        want = np.asarray(_lax_solve(jnp.asarray(c)))
        got = TA._solve_square_plain(torch.from_numpy(c)).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32


@pytest.mark.parametrize("case", range(3))
def test_solve_square_ties_identical_to_lax(case):
    c = _tie_matrices()[case]
    k = c.shape[0]
    want = np.asarray(_lax_solve(jnp.asarray(c)))
    got = TA.solve_square(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, want)
    r, cc = linear_sum_assignment(c)
    np.testing.assert_allclose(c[got, np.arange(k)].sum(), c[r, cc].sum(),
                               atol=1e-6)


def _square_signed_zeros():
    rng = np.random.default_rng(41)
    c = rng.integers(-1, 2, (33, 33)).astype(np.float32)
    c[(c == 0) & (rng.uniform(size=(33, 33)) < 0.5)] = -0.0
    c[:, 0], c[:, 1] = -0.0, 0.0
    return c


def _square_forced_padded():
    """The (8, 8) square ``_forced_prep`` builds for a padded (5, 8)
    problem: absorbing edges, zeros on invalid slots."""
    rng = np.random.default_rng(42)
    cost = torch.from_numpy(rng.uniform(-1, 0, (1, 5, 8)).astype(np.float32))
    rm = torch.tensor([[True, True, False, True, True]])
    cm = torch.from_numpy(rng.uniform(size=(1, 8)) < 0.6)
    return TA._forced_prep(cost, rm, cm)[0][0].numpy()


_SQUARE_EDGES = {
    "signed_zeros_k33": _square_signed_zeros,
    "all_equal_rows_k16": lambda: np.repeat(np.random.default_rng(43).normal(
        size=(1, 16)).astype(np.float32), 16, axis=0),
    "forced_padded_k8": _square_forced_padded,
}


@pytest.mark.parametrize("case", list(_SQUARE_EDGES))
def test_solve_square_plain_edge_cases_identical_to_lax(case):
    """The plain solver, which K1 is held to on the card bit for bit, on
    the warp kernel's edge cases: -0.0 beside +0.0 (ragged runs at
    K = 33), rows all equal, and a padded forced-matching square."""
    c = _SQUARE_EDGES[case]()
    want = np.asarray(_lax_solve(jnp.asarray(c)))
    got = TA._solve_square_plain(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, want)
    r, cc = linear_sum_assignment(c)
    np.testing.assert_allclose(c[got, np.arange(c.shape[0])].sum(),
                               c[r, cc].sum(), atol=1e-5)


def test_batched_plain_blocks_and_inactive():
    """The batched entry solves the leading k_eff block, -1 elsewhere, and
    skips inactive problems, like the kernel."""
    rng = np.random.default_rng(3)
    c = torch.from_numpy(rng.normal(size=(3, 8, 8)).astype(np.float32))
    k = torch.tensor([4, 8, 8], dtype=torch.int32)
    on = torch.tensor([True, False, True])
    out = solve_square_batched(c, k, on)
    assert out.shape == (3, 8) and out.dtype == torch.int32
    np.testing.assert_array_equal(out[0, :4], TA._solve_square_plain(c[0, :4, :4]))
    assert (out[0, 4:] == -1).all() and (out[1] == -1).all()
    np.testing.assert_array_equal(out[2], TA._solve_square_plain(c[2]))


def _forced_both(cost, rm, cm):
    want = np.asarray(_jax_forced(jnp.asarray(cost), jnp.asarray(rm),
                                  jnp.asarray(cm)))
    got = TA.matching_forced(torch.from_numpy(cost), torch.from_numpy(rm),
                             torch.from_numpy(cm)).numpy()
    return got, want


@pytest.mark.parametrize("shape,p_col", [((5, 8), 0.5), ((8, 5), 0.7),
                                         ((32, 64), 0.3), ((32, 64), 0.8)])
def test_matching_forced_masked_rectangles(shape, p_col):
    """Masked rectangles: fast paths, the compacted (R, R) solve when few
    columns are live, and the full square otherwise."""
    R, C = shape
    rng = np.random.default_rng(R * C + int(p_col * 10))
    for _ in range(4):
        cost = rng.uniform(-1, 0, (R, C)).astype(np.float32)
        rm = rng.uniform(size=R) < 0.8
        cm = rng.uniform(size=C) < p_col
        got, want = _forced_both(cost, rm, cm)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(3, 5), (5, 3), (4, 4)])
def test_matching_forced_integer_ties(shape):
    """The tie-heavy integer matrices of test_assignment_ties.py: identical
    row2col to the JAX package, and scipy's objective."""
    R, C = shape
    rng = np.random.default_rng(R * 10 + C)
    ones_r, ones_c = np.ones(R, bool), np.ones(C, bool)
    for _ in range(30):
        cost = rng.integers(0, 5, (R, C)).astype(np.float32)
        got, want = _forced_both(cost, ones_r, ones_c)
        np.testing.assert_array_equal(got, want)
        ri, ci = linear_sum_assignment(cost)
        m = got >= 0
        assert m.sum() == min(R, C)
        assert abs(cost[np.nonzero(m)[0], got[m]].sum()
                   - cost[ri, ci].sum()) < 1e-6


@pytest.mark.parametrize("shape", [(5, 8), (8, 5), (6, 6)])
def test_strict_argmin_fast_path(shape):
    R, C = shape
    rng = np.random.default_rng(R * 10 + C)
    for _ in range(10):
        n = min(R, C)
        perm = rng.permutation(max(R, C))[:n]
        cost = rng.uniform(5.0, 9.0, (R, C))
        for i in range(n):
            if R <= C:
                cost[i, perm[i]] = rng.uniform(0.0, 1.0)
            else:
                cost[perm[i], i] = rng.uniform(0.0, 1.0)
        cost = cost.astype(np.float32)
        got, want = _forced_both(cost, np.ones(R, bool), np.ones(C, bool))
        np.testing.assert_array_equal(got, want)
        ri, ci = linear_sum_assignment(cost)
        exp = np.full(R, -1)
        exp[ri] = ci
        np.testing.assert_array_equal(got, exp)


def test_fast_path_with_masks_and_inf():
    cost = np.array([[0.1, 9.0, 9.0, 5.0],
                     [9.0, 0.2, 9.0, 5.0],
                     [9.0, 9.0, np.inf, 5.0]], np.float32)
    rm = np.array([True, True, False])
    cm = np.array([True, True, True, False])
    got, want = _forced_both(cost, rm, cm)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0, 1, -1])


def test_compaction_keeps_inf_semantics():
    """Non-finite costs through the compacted solve: the port's gather
    reproduces the JAX one-hot product's NaN rows (inf * 0)."""
    rng = np.random.default_rng(11)
    R, C = 4, 9
    cost = rng.uniform(-1, 0, (R, C)).astype(np.float32)
    cost[1, 7] = np.inf
    cost[2, 0] = -np.inf
    cm = np.zeros(C, bool)
    cm[[0, 3, 5, 7]] = True
    got, want = _forced_both(cost, np.ones(R, bool), cm)
    np.testing.assert_array_equal(got, want)


@functools.lru_cache(maxsize=None)
def _jax_greedy():
    return jax.jit(JA.greedy_unique_match)


def test_greedy_unique_match():
    rng = np.random.default_rng(2)
    for _ in range(5):
        s = rng.uniform(size=(6, 7)).astype(np.float32)
        rm, cm = rng.uniform(size=6) < 0.8, rng.uniform(size=7) < 0.8
        ju, jr = _jax_greedy()(jnp.asarray(s), jnp.asarray(rm),
                               jnp.asarray(cm), 0.8)
        tu, tr = TA.greedy_unique_match(torch.from_numpy(s),
                                        torch.from_numpy(rm),
                                        torch.from_numpy(cm), 0.8)
        assert bool(tu) == bool(ju)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
