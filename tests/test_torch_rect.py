"""tracklab_torch rectangular assignment (K2's plain version and its callers)
vs the JAX package on the CPU.

The port's rectangular solver follows ``_solve_rect_lax`` step for step, so
``col2row`` must be identical on continuous costs; on tie-heavy costs it
must reach the optimum of scipy and of K2's Pallas kernel in interpret
mode. ``_forced_rect``, ``matching_forced(batched=True)`` and
``matching_limit`` (both modes) must agree with the JAX functions on the
40-draw cases of test_batched_mode.py, one problem at a time and as one
stack of 40 problems (which holds every reduction to its own problem).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from tracklab_tpu.ops import assignment as JA
from tracklab_tpu.ops.assignment_pallas import solve_rect_batched_pallas
from tracklab_torch.kernels.jv_rect import (solve_rect_batched,
                                            solve_rect_batched_plain)
from tracklab_torch.ops import assignment as TA

# one intra-op thread per process: the suite runs in parallel workers,
# and a torch thread pool per worker oversubscribes the cores
torch.set_num_threads(1)


def _rect_objective(c, col2row):
    R = c.shape[0]
    rows = col2row[col2row < R]
    assert len(set(rows.tolist())) == len(rows)
    cols = np.nonzero(col2row < R)[0]
    return len(rows), c[rows, cols].sum()


@functools.lru_cache(maxsize=None)
def _jax_rect():
    return jax.jit(JA._solve_rect_lax)


@pytest.mark.parametrize("shape", [(3, 7), (8, 16), (12, 30), (13, 40)])
def test_solve_rect_identical_to_lax(shape):
    R, C = shape
    rng = np.random.default_rng(R * 100 + C)
    cs = rng.normal(size=(3, R, C)).astype(np.float32)
    want = np.stack([np.asarray(_jax_rect()(jnp.asarray(c))) for c in cs])
    got = TA.solve_rect(torch.from_numpy(cs)).numpy()
    assert got.dtype == np.int32 and got.shape == (3, C)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TA.solve_rect(torch.from_numpy(cs[1])),
                                  want[1])
    for c, g in zip(cs, got):
        n, obj = _rect_objective(c, g)
        rr, cc = linear_sum_assignment(c)
        assert n == R
        np.testing.assert_allclose(obj, c[rr, cc].sum(), rtol=1e-5)


def _tie_cases():
    R, C = 6, 20
    c = np.zeros((2, R, C), np.float32)
    c[0, :4, :3] = -2.0       # absorbing block with ties
    c[1, :, :] = 1.0          # fully degenerate
    return c


@pytest.fixture(scope="module")
def pallas_ties():
    return np.asarray(solve_rect_batched_pallas(jnp.asarray(_tie_cases()),
                                                interpret=True))


def test_solve_rect_ties_reach_pallas_and_scipy_objective(pallas_ties):
    c = _tie_cases()
    got = solve_rect_batched(torch.from_numpy(c)).numpy()
    want = np.stack([np.asarray(_jax_rect()(jnp.asarray(x))) for x in c])
    np.testing.assert_array_equal(got, want)
    for v in range(2):
        n, obj = _rect_objective(c[v], got[v])
        n_p, obj_p = _rect_objective(c[v], pallas_ties[v])
        rr, cc = linear_sum_assignment(c[v])
        assert n == n_p == c.shape[1]
        np.testing.assert_allclose(obj, obj_p, atol=1e-6)
        np.testing.assert_allclose(obj, c[v][rr, cc].sum(), atol=1e-6)


def test_rect_batched_plain_active_and_errors():
    rng = np.random.default_rng(7)
    c = torch.from_numpy(rng.normal(size=(3, 4, 9)).astype(np.float32))
    on = torch.tensor([True, False, True])
    out = solve_rect_batched(c, on)
    assert (out[1] == 4).all()
    np.testing.assert_array_equal(out[0], TA._solve_rect_plain(c[0]))
    np.testing.assert_array_equal(out[2], solve_rect_batched_plain(c)[2])
    stats = {}
    TA._solve_rect_plain(c[0], stats)
    assert stats["steps"] >= 4
    with pytest.raises(ValueError):
        solve_rect_batched(c.transpose(1, 2))
    with pytest.raises(ValueError):
        solve_rect_batched(c[0])


def _signed_zeros(rng, R, C):
    """-1, -0.0, +0.0 and 1, with -0.0 and +0.0 in every row."""
    c = rng.integers(-1, 2, (R, C)).astype(np.float32)
    c[(c == 0) & (rng.uniform(size=(R, C)) < 0.5)] = -0.0
    c[:, 0], c[:, 1] = -0.0, 0.0
    return c


def _forced_rect_matrix(R, C, seed):
    """The matrix ``_forced_rect`` hands the rectangular solver on a padded
    problem: normalised valid costs minus 2, zeros on invalid slots."""
    rng = np.random.default_rng(seed)
    cost = torch.from_numpy(rng.uniform(-1, 0, (1, R, C)).astype(np.float32))
    rm = torch.from_numpy(rng.uniform(size=(1, R)) < 0.75)
    cm = torch.from_numpy(rng.uniform(size=(1, C)) < 0.65)
    finite = torch.isfinite(cost) & rm[:, :, None] & cm[:, None, :]
    c_hat = TA._normalise(cost, finite)
    return torch.where(finite, c_hat, torch.zeros_like(c_hat))[0].numpy()


_RECT_EDGES = {
    "signed_zeros": lambda: _signed_zeros(np.random.default_rng(21), 5, 33),
    "ragged_c33": lambda: np.random.default_rng(22).normal(
        size=(5, 33)).astype(np.float32),
    "all_equal_rows": lambda: np.repeat(np.random.default_rng(23).normal(
        size=(1, 33)).astype(np.float32), 5, axis=0),
    "forced_padded": lambda: _forced_rect_matrix(8, 16, 24),
}


@pytest.mark.parametrize("case", list(_RECT_EDGES))
def test_rect_plain_edge_cases_identical_to_lax(case):
    """The plain solver, which K2 is held to on the card bit for bit, on
    the warp kernel's edge cases: ties between -0.0 and +0.0, a ragged last
    lane run (C = 33), rows all equal, and a padded forced-matching
    problem (zeros on invalid slots)."""
    c = _RECT_EDGES[case]()
    want = np.asarray(_jax_rect()(jnp.asarray(c)))
    got = solve_rect_batched_plain(torch.from_numpy(c)[None])[0].numpy()
    np.testing.assert_array_equal(got, want)
    n, obj = _rect_objective(c, got)
    rr, cc = linear_sum_assignment(c)
    assert n == c.shape[0]
    np.testing.assert_allclose(obj, c[rr, cc].sum(), atol=1e-5)


def _warp_argmin(reach, used):
    """The warp kernels' argmin rule (csrc/jv_rect.cu, csrc/jv.cu) in numpy:
    lane l holds the columns [l*W, l*W + W), W = ceil(C/32); a column's
    key is the order-preserving image of its value with -0.0 made +0.0, a
    used column's key the largest; each lane takes its run's lowest
    minimum, the warp the smallest key (redux.sync) and the lowest lane
    holding it (ballot, ffs). Returns the column and the decoded value."""
    C = reach.shape[0]
    W = -(-C // 32)
    b = (reach + np.float32(0.0)).view(np.uint32)
    keys = np.where(b >> 31 == 1, ~b, b | np.uint32(0x80000000))
    keys = np.where(used, np.uint32(0xFFFFFFFF), keys)
    runs = np.full(32 * W, 0xFFFFFFFF, np.uint32)
    runs[:C] = keys
    runs = runs.reshape(32, W)
    kb, tb = runs.min(axis=1), runs.argmin(axis=1)
    lane = int(np.flatnonzero(kb == kb.min())[0])
    k = kb[lane]
    bits = k ^ np.uint32(0x80000000) if k >> 31 else ~k
    return lane * W + int(tb[lane]), np.uint32(bits).view(np.float32)


def test_warp_argmin_rule_matches_torch_argmin():
    """On rows with ties, -0.0 beside +0.0, used (inf) columns and ragged
    widths, the warp rule gives torch.argmin's index and the exact minimum,
    as the solvers' step needs it."""
    rng = np.random.default_rng(31)
    for C in (1, 7, 32, 33, 64, 100, 128, 200, 256):
        for _ in range(40):
            x = rng.integers(-2, 3, C).astype(np.float32) * np.float32(0.5)
            x[(x == 0) & (rng.uniform(size=C) < 0.5)] = -0.0
            used = rng.uniform(size=C) < 0.3
            used[rng.integers(C)] = False           # a column stays free
            reach = np.where(used, np.float32(np.inf), x)
            j, val = _warp_argmin(reach, used)
            want = int(torch.argmin(torch.from_numpy(reach)))
            assert j == want and val == reach[want]
        x = rng.normal(size=C).astype(np.float32)
        assert _warp_argmin(x, np.zeros(C, bool))[0] == int(np.argmin(x))


def _draws(shape, n=40):
    """The 40 draws of test_batched_mode.py:test_solver_batched_equivalence."""
    R, C = shape
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        cost = rng.normal(size=(R, C)) * rng.uniform(0.1, 3)
        rm = rng.uniform(size=R) < 0.8
        cm = rng.uniform(size=C) < 0.7
        out.append((cost, rm, cm))
    return out


def _totals(cost, r2c):
    m = r2c >= 0
    return int(m.sum()), float(cost[np.nonzero(m)[0], r2c[m]].sum())


_JAX_FNS = {
    "forced_rect": lambda c, r, m: JA._forced_rect(c, r, m),
    "forced_batched": lambda c, r, m: JA.matching_forced(c, r, m,
                                                         batched=True),
    "forced": lambda c, r, m: JA.matching_forced(c, r, m),
    "limit": lambda c, r, m: JA.matching_limit(c, r, m, 0.9),
    "limit_batched": lambda c, r, m: JA.matching_limit(c, r, m, 0.9,
                                                       batched=True),
}
_TORCH_FNS = {
    "forced_rect": lambda c, r, m: TA._forced_rect(c, r, m),
    "forced_batched": lambda c, r, m: TA.matching_forced(c, r, m,
                                                         batched=True),
    "forced": lambda c, r, m: TA.matching_forced(c, r, m),
    "limit": lambda c, r, m: TA.matching_limit(c, r, m, 0.9),
    "limit_batched": lambda c, r, m: TA.matching_limit(c, r, m, 0.9,
                                                       batched=True),
}


@pytest.fixture(scope="module")
def jax_draws():
    """JAX results per (shape, function), each draw solved on its own."""
    out = {}
    for shape in [(8, 16), (16, 8), (12, 12)]:
        draws = _draws(shape)
        for name, fn in _JAX_FNS.items():
            f = jax.jit(fn)
            out[shape, name] = np.stack([np.asarray(f(*d)) for d in draws])
    return out


@pytest.mark.parametrize("name", list(_TORCH_FNS))
@pytest.mark.parametrize("shape", [(8, 16), (16, 8), (12, 12)])
def test_matchings_agree_with_jax_on_batched_mode_draws(jax_draws, shape,
                                                        name):
    draws = _draws(shape)
    want = jax_draws[shape, name]
    stack = [torch.from_numpy(np.stack(x)) for x in zip(*draws)]
    got = _TORCH_FNS[name](*stack).numpy()                 # 40 problems
    assert got.shape == want.shape and got.dtype == np.int32
    for i, (cost, rm, cm) in enumerate(draws):
        one = _TORCH_FNS[name](*map(torch.from_numpy, (cost, rm, cm)))
        np.testing.assert_array_equal(one.numpy(), got[i])
        ca, sa = _totals(cost, got[i])
        cb, sb = _totals(cost, want[i])
        if name.startswith("limit"):
            # equal objective of the cost-limit program (ties may permute)
            assert abs((0.9 * ca - sa) - (0.9 * cb - sb)) < 1e-8
        else:
            assert ca == cb and abs(sa - sb) < 1e-8
    np.testing.assert_array_equal(got, want)
