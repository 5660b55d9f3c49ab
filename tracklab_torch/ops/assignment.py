"""Linear assignment in PyTorch (counterpart of tracklab_tpu.ops.assignment).

The exact Jonker-Volgenant cores are :func:`solve_square` and
:func:`solve_rect`: the plain torch solvers on CPU tensors, kernels K1
(``kernels/jv.py``, square) and K2 (``kernels/jv_rect.py``, rectangular)
on CUDA tensors.

Every matching function takes one problem, ``cost (R, C)`` with masks
``(R,)`` and ``(C,)``, or a stack of V independent problems with a leading
axis, ``cost (V, R, C)`` with masks ``(V, R)`` and ``(V, C)``: the
counterpart of ``jax.vmap`` over the JAX function. Every reduction (the
normalising scale, the fast-path tests) runs over each problem's own axes.

The JAX package picks among fast paths and solve variants with
``lax.cond``. A Python ``if`` on a CUDA tensor would sync with the host on
every frame, so here every branch that is cheap is computed and the result
is selected with ``torch.where``; the one expensive branch, the JV solve,
is a single batched launch for all V problems whose per-problem ``active``
flag (and, for K1, ``k_eff`` size) is set on the device. On CPU tensors
the plain batched solvers read those flags and skip inactive problems.
``batched=True`` is the JAX package's cond-free mode: one rectangular
solve per problem through K2, no fast paths.

Capacity padding: callers pass full (R, C) cost matrices plus boolean
row/col validity masks; invalid slots are routed to absorbing edges that
never perturb the valid-block optimum.
"""
from __future__ import annotations

import functools

import torch

from tracklab_torch.kernels.jv import _solve_square_plain, solve_square_batched
from tracklab_torch.kernels.jv_rect import (_solve_rect_plain,
                                            solve_rect_batched)

__all__ = ["solve_square", "solve_rect", "matching_forced", "matching_limit",
           "min_cost_matching", "greedy_unique_match", "_solve_square_plain",
           "_solve_rect_plain", "_col2row_to_row2col"]


def _one_or_many(fn):
    """Let ``fn``, written for a leading problem axis, take one problem:
    a 2-D cost gets the axis added (with its masks and any tensor
    argument) and dropped from every result again."""

    def lift(a):
        return a.reshape(1, *a.shape) if isinstance(a, torch.Tensor) else a

    @functools.wraps(fn)
    def wrapper(cost, row_mask, col_mask, *args, **kwargs):
        if cost.dim() == 3:
            return fn(cost, row_mask, col_mask, *args, **kwargs)
        out = fn(cost[None], row_mask[None], col_mask[None],
                 *map(lift, args), **{k: lift(a) for k, a in kwargs.items()})
        return tuple(o[0] for o in out) if isinstance(out, tuple) else out[0]

    return wrapper


def solve_square(cost: torch.Tensor) -> torch.Tensor:
    """Exact min-cost perfect matching on a square (K, K) float matrix.
    Returns ``col2row`` (K,) int32. All costs must be finite."""
    K = cost.shape[0]
    k = torch.full((1,), K, dtype=torch.int32, device=cost.device)
    on = torch.ones(1, dtype=torch.bool, device=cost.device)
    return solve_square_batched(cost[None], k, on)[0]


def solve_rect(cost: torch.Tensor, active=None) -> torch.Tensor:
    """Exact min-cost assignment of ALL R rows of an (R, C) matrix, R <= C,
    to distinct columns, or of each problem of a (V, R, C) stack. Returns
    ``col2row`` (C,) or (V, C) int32; the value R means unassigned.

    R == C goes to the square solver (K1 on CUDA), as in the JAX package;
    otherwise one K2 launch solves all V problems. ``active`` (V,) bool,
    optional: a problem whose result the caller discards reports every
    column unassigned without solving."""
    if cost.dim() == 2:
        return solve_rect(cost[None], None if active is None
                          else active.reshape(1))[0]
    V, R, C = cost.shape
    if R != C:
        return solve_rect_batched(cost, active)
    k = torch.full((V,), R, dtype=torch.int32, device=cost.device)
    if active is None:
        active = torch.ones(V, dtype=torch.bool, device=cost.device)
    out = solve_square_batched(cost, k, active)
    return torch.where(out < 0, R, out)


def _col2row_to_row2col(col2row: torch.Tensor, n_rows_total: int):
    """Invert a col->row map (..., K) into row->col (..., n_rows_total);
    rows that no column holds get -1."""
    K = col2row.shape[-1]
    lead = col2row.shape[:-1]
    dev = col2row.device
    row2col = torch.full(lead + (n_rows_total + 1,), -1, dtype=torch.int32,
                         device=dev)
    cols = torch.arange(K, dtype=torch.int32, device=dev).expand(lead + (K,))
    ok = (col2row >= 0) & (col2row < n_rows_total)
    safe_rows = torch.where(ok, col2row, n_rows_total).long()
    row2col.scatter_(-1, safe_rows, cols)
    return row2col[..., :n_rows_total]


def _argmax_first(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 when none), int32."""
    return torch.argmax(mask.to(torch.int32), dim=dim).to(torch.int32)


def _take_cols(x, idx):
    """``x[v, r, idx[v, r]]`` for x (V, R, C) and idx (V, R) int64."""
    return x.gather(2, idx[..., None])[..., 0]


@_one_or_many
def matching_forced(cost, row_mask, col_mask, need=None, batched=False):
    """scipy-style forced rectangular matching on a padded matrix.

    Matches every valid row/col up to min(#valid rows, #valid cols),
    minimizing total cost on the valid block. Costs are normalized to
    [-1, 1] and shifted by -2 on the valid-valid block; every edge touching
    an invalid slot costs 0, so every optimum has maximum valid-valid
    cardinality and is optimal on the valid block.

    Default mode: the strict-argmin fast paths (each valid row's, or
    column's, masked minimum is unique and the argmins are distinct) give
    the unique optimum without a solve; the other problems share one K1
    launch. ``batched=True``: the cond-free form, one rectangular solve per
    problem (:func:`_forced_rect`, K2). ``need`` is an optional bool per
    problem: False means the caller discards the result, so its solve is
    skipped (the kernel exits at once). Returns row2col int32: the matched
    valid column per valid row, else -1.
    """
    if batched:
        return _forced_rect(cost, row_mask, col_mask, need)
    V, R, C = cost.shape
    dev = cost.device
    inf = torch.full((), float("inf"), dtype=cost.dtype, device=dev)
    valid = row_mask[:, :, None] & col_mask[:, None, :]
    feas = torch.where(valid & torch.isfinite(cost), cost, inf)
    nR = row_mask.sum(dim=1, dtype=torch.int32)
    nC = col_mask.sum(dim=1, dtype=torch.int32)
    ar_c = torch.arange(C, dtype=torch.int32, device=dev)
    ar_r = torch.arange(R, dtype=torch.int32, device=dev)

    rmin = feas.amin(dim=2)
    ramin = torch.argmin(feas, dim=2).to(torch.int32)
    r_strict = (((feas == rmin[:, :, None]).sum(dim=2) == 1)
                & torch.isfinite(rmin))
    r_hot = ((ramin[:, :, None] == ar_c)
             & (row_mask & r_strict)[:, :, None])
    row_fast_ok = ((nR <= nC) & torch.all(r_strict | ~row_mask, dim=1)
                   & torch.all(r_hot.sum(dim=1) <= 1, dim=1))

    cmin = feas.amin(dim=1)
    camin = torch.argmin(feas, dim=1).to(torch.int32)
    c_strict = (((feas == cmin[:, None, :]).sum(dim=1) == 1)
                & torch.isfinite(cmin))
    c_hot = ((camin[:, None, :] == ar_r[:, None])
             & (col_mask & c_strict)[:, None, :])
    col_fast_ok = ((nC < nR) & torch.all(c_strict | ~col_mask, dim=1)
                   & torch.all(c_hot.sum(dim=2) <= 1, dim=1))

    row_fast = torch.where(row_mask & r_strict, ramin, -1)
    col_fast = torch.where(c_hot.any(dim=2), _argmax_first(c_hot, 2), -1)

    slow_need = ~(row_fast_ok | col_fast_ok)
    if need is not None:
        slow_need = slow_need & need
    slow = _matching_forced_jv(cost, row_mask, col_mask, slow_need)
    return torch.where(row_fast_ok[:, None], row_fast,
                       torch.where(col_fast_ok[:, None], col_fast, slow))


def _normalise(cost, finite):
    """Per-problem ``clip(cost / max|cost|, -1, 1) - 2`` over the finite
    valid entries (0 elsewhere), as ``_forced_core``/``_forced_rect``."""
    zero = torch.zeros((), dtype=cost.dtype, device=cost.device)
    scale = torch.clamp(torch.where(finite, cost.abs(), zero).amax(dim=(1, 2)),
                        min=1e-9)
    return torch.clamp(torch.where(finite, cost, zero) / scale[:, None, None],
                       -1.0, 1.0) - 2.0


def _forced_prep(cost, row_mask, col_mask):
    """The absorbing-edge squares of ``_forced_core``: returns the
    (V, S, S) matrices (S = max(R, C)) and the finite-and-valid mask."""
    V, R, C = cost.shape
    S = max(R, C)
    valid = row_mask[:, :, None] & col_mask[:, None, :]
    finite = torch.isfinite(cost) & valid
    c_hat = _normalise(cost, finite)
    sq = torch.zeros((V, S, S), dtype=cost.dtype, device=cost.device)
    sq[:, :R, :C] = torch.where(valid, c_hat, torch.zeros_like(c_hat))
    return sq, finite


def _forced_finish(col2row, finite, row_mask, col_mask):
    """Strip pairs that used absorbing edges or invalid slots."""
    V, R, C = finite.shape
    row2col = _col2row_to_row2col(col2row, R)
    cols_ok = (row2col >= 0) & (row2col < C)
    safe_col = torch.where(cols_ok, row2col, 0).long()
    pair_valid = (cols_ok & row_mask & col_mask.gather(1, safe_col)
                  & _take_cols(finite, safe_col))
    return torch.where(pair_valid, row2col, -1)


@_one_or_many
def _forced_rect(cost, row_mask, col_mask, need=None):
    """matching_forced semantics through one rectangular solve per problem
    (K2), with no fast paths: the JAX package's cond-free form. Same
    absorbing-edge construction as ``_forced_core`` on the (R, C)
    rectangle; when R > C the problem is transposed."""
    V, R, C = cost.shape
    if R > C:
        # solve the transposed problem (C rows over R columns), then
        # invert its col -> row map back to row2col
        c2r = _forced_rect(cost.transpose(1, 2), col_mask, row_mask, need)
        ar_r = torch.arange(R, dtype=torch.int32, device=cost.device)
        sel = ((c2r[:, None, :] == ar_r[:, None])
               & (c2r >= 0)[:, None, :])                    # (V, R, C)
        return torch.where(sel.any(dim=2), _argmax_first(sel, 2), -1)
    valid = row_mask[:, :, None] & col_mask[:, None, :]
    finite = torch.isfinite(cost) & valid
    c_hat = _normalise(cost, finite)
    rect = torch.where(finite, c_hat, torch.zeros_like(c_hat))
    col2row = solve_rect(rect, need)
    return _forced_finish(col2row, finite, row_mask, col_mask)


def _forced_core(cost, row_mask, col_mask, need):
    """Forced matching through one square solve per problem (no
    compaction), skipped on the device where ``need`` is False."""
    sq, finite = _forced_prep(cost, row_mask, col_mask)
    V, S = sq.shape[0], sq.shape[1]
    k = torch.full((V,), S, dtype=torch.int32, device=cost.device)
    c2r = solve_square_batched(sq, k, need)
    return _forced_finish(c2r, finite, row_mask, col_mask)


def _compact_cols(col_mask):
    """Column compaction: the number of valid columns per problem and the
    permutation ``colmap`` (V, C) int64 that puts them first, in order
    (``colmap[v, j]`` is the original column at compacted slot j)."""
    V, C = col_mask.shape
    col_i = col_mask.to(torch.int32)
    n_act = col_i.sum(dim=1, dtype=torch.int32)
    rank_a = torch.cumsum(col_i, 1, dtype=torch.int32) - 1
    rank_i = torch.cumsum(1 - col_i, 1, dtype=torch.int32) - 1
    pos = torch.where(col_mask, rank_a, n_act[:, None] + rank_i)
    colmap = torch.empty((V, C), dtype=torch.int64, device=col_mask.device)
    colmap.scatter_(1, pos.long(), torch.arange(
        C, device=col_mask.device).expand(V, C))
    return n_act, colmap


def _permute_cols_like_onehot_matmul(cost, colmap):
    """``cost @ onehot`` for the one-hot column permutation ``colmap``,
    as a gather that keeps the product's IEEE semantics: a non-finite entry
    elsewhere in a row turns the whole permuted row into NaN (inf * 0)."""
    g = cost.gather(2, colmap[:, None, :].expand(cost.shape))
    n_bad = (~torch.isfinite(cost)).sum(dim=2, keepdim=True)
    other_bad = (n_bad - (~torch.isfinite(g)).to(n_bad.dtype)) > 0
    return torch.where(other_bad, torch.full_like(g, float("nan")), g)


def _uncompact(r2c, colmap):
    """Map compacted column ids back to original ones (-1 stays -1)."""
    ok = r2c >= 0
    orig = colmap.gather(1, torch.where(ok, r2c, 0).long()).to(torch.int32)
    return torch.where(ok, orig, -1)


def _matching_forced_jv(cost, row_mask, col_mask, need):
    """The JV solve path of :func:`matching_forced`, as ONE batched K1
    launch. When C > R and at most R columns of a problem are valid, its
    valid columns are permuted to the front and the (R, R) block is solved
    instead of the (C, C) square (column compaction); ``k_eff`` selects
    which, per problem, on the device."""
    V, R, C = cost.shape
    if C <= R:
        return _forced_core(cost, row_mask, col_mask, need)
    sq_full, fin_full = _forced_prep(cost, row_mask, col_mask)
    n_act, colmap = _compact_cols(col_mask)
    perm_cost = _permute_cols_like_onehot_matmul(cost, colmap)
    perm_mask = col_mask.gather(1, colmap)
    sq_small, fin_small = _forced_prep(perm_cost[:, :, :R], row_mask,
                                       perm_mask[:, :R])

    small = n_act <= R
    sq = sq_full.clone()
    sq[:, :R, :R] = torch.where(small[:, None, None], sq_small,
                                sq_full[:, :R, :R])
    k = torch.where(small, R, C).to(torch.int32)
    c2r = solve_square_batched(sq, k, need)

    r2c_small = _uncompact(_forced_finish(c2r[:, :R], fin_small, row_mask,
                                          perm_mask[:, :R]), colmap)
    r2c_full = _forced_finish(c2r, fin_full, row_mask, col_mask)
    return torch.where(small[:, None], r2c_small, r2c_full)


def _limit_finish(r2c, wn):
    """Keep the pairs of a max-weight solve whose weight is positive."""
    C = wn.shape[2]
    cols_ok = (r2c >= 0) & (r2c < C)
    safe_col = torch.where(cols_ok, r2c, 0).long()
    ok = cols_ok & (_take_cols(wn, safe_col) > 0.0)
    return torch.where(ok, r2c, -1)


@_one_or_many
def matching_limit(cost, row_mask, col_mask, limit, batched=False):
    """``lap.lapjv(extend_cost=True, cost_limit=limit)`` semantics.

    A valid pair (i, j) is matched only when beneficial versus routing both
    endpoints to dummies at limit/2 each, i.e. pairs costing more than
    ``limit`` stay unmatched. That is MAX-WEIGHT matching with weights
    ``w = (limit - cost)+``, normalised per problem, solved on the
    zero-padded square of size max(R, C).

    Default mode: when the strictly-sub-limit candidate graph of a problem
    is a unique partial matching (and no edge sits exactly at the limit) it
    is the answer; the other problems share one K1 launch, column-compacted
    to (R, R) where at most R columns are valid. ``batched=True``: the
    cond-free form, one rectangular max-weight solve per problem (K2,
    transposed when C < R). Returns row2col int32, -1 where unmatched.
    """
    V, R, C = cost.shape
    valid = row_mask[:, :, None] & col_mask[:, None, :]
    finite = torch.isfinite(cost) & valid
    zero = torch.zeros((), dtype=cost.dtype, device=cost.device)
    w = torch.where(finite, torch.clamp(limit - cost, min=0.0), zero)
    scale = torch.clamp(w.amax(dim=(1, 2)), min=1e-9)
    wn = w / scale[:, None, None]

    if batched:
        if C >= R:
            r2c = _col2row_to_row2col(solve_rect(-wn), R)
        else:
            # transposed: each original row (a column there) reports the
            # original column (a row there) assigned to it, C if none
            col2row = solve_rect(-wn.transpose(1, 2))
            r2c = torch.where(col2row < C, col2row, -1)
        return _limit_finish(r2c, wn)

    # Exact fast path: edges costing more than ``limit`` never match, and
    # when the strictly-sub-limit graph is a unique partial matching every
    # optimum contains all of it. Edges exactly at the limit tie with their
    # dummy route, so their presence forces the solve.
    sub = finite & (cost < limit)
    at_limit = (finite & (cost == limit)).any(dim=2).any(dim=1)
    is_unique, fast_r2c = _unique_partial_matching(sub)
    is_unique = is_unique & ~at_limit
    slow = _matching_limit_jv(wn, col_mask, ~is_unique)
    return torch.where(is_unique[:, None], fast_r2c, slow)


def _matching_limit_jv(wn, col_mask, need):
    """The JV solve path of :func:`matching_limit` (``solve_block`` of the
    JAX package) as ONE batched K1 launch, with column compaction when
    C > R and at most R columns of a problem are valid."""
    V, R, C = wn.shape
    dev = wn.device
    if C <= R:
        sq = torch.zeros((V, R, R), dtype=wn.dtype, device=dev)
        sq[:, :, :C] = -wn
        k = torch.full((V,), R, dtype=torch.int32, device=dev)
        c2r = solve_square_batched(sq, k, need)
        return _limit_finish(_col2row_to_row2col(c2r, R), wn)
    n_act, colmap = _compact_cols(col_mask)
    perm = wn.gather(2, colmap[:, None, :].expand(wn.shape))[:, :, :R]
    small = n_act <= R
    sq = torch.zeros((V, C, C), dtype=wn.dtype, device=dev)
    sq[:, :R, :] = -wn
    sq[:, :R, :R] = torch.where(small[:, None, None], -perm, sq[:, :R, :R])
    k = torch.where(small, R, C).to(torch.int32)
    c2r = solve_square_batched(sq, k, need)
    r2c_small = _uncompact(_limit_finish(
        _col2row_to_row2col(c2r[:, :R], R), perm), colmap)
    r2c_full = _limit_finish(_col2row_to_row2col(c2r, R), wn)
    return torch.where(small[:, None], r2c_small, r2c_full)


def _unique_partial_matching(sub):
    """(is_unique (V,), row2col (V, R)) for boolean candidate matrices
    (V, R, C): unique when each row and each column has at most one
    candidate. row2col only means something where is_unique."""
    counts_r = sub.sum(dim=2, dtype=torch.int32)
    counts_c = sub.sum(dim=1, dtype=torch.int32)
    is_unique = (torch.all(counts_r <= 1, dim=1)
                 & torch.all(counts_c <= 1, dim=1))
    row2col = torch.where(sub.any(dim=2), _argmax_first(sub, 2), -1)
    return is_unique, row2col


@_one_or_many
def min_cost_matching(cost, row_mask, col_mask, max_distance: float,
                      batched=False):
    """DeepSORT-family ``min_cost_matching`` semantics
    (strong_sort/sort/linear_assignment.py:55-73): clamp costs above
    ``max_distance`` to max + 1e-5, run forced matching, drop matched pairs
    whose true cost exceeds the threshold. Returns row2col int32, -1 where
    unmatched.

    Default mode: when a problem's sub-threshold candidate graph has at
    most one candidate per row and per column, that partial matching is
    the exact answer; it is selected on the device, and the problems that
    need the forced solve share one K1 launch (``need`` flags the others,
    whose solve exits at once). ``batched=True``: the cond-free form, one
    rectangular solve per problem (K2)."""
    valid = (row_mask[:, :, None] & col_mask[:, None, :]
             & torch.isfinite(cost))
    sub = valid & (cost <= max_distance)
    need = None
    if not batched:
        is_unique, fast_r2c = _unique_partial_matching(sub)
        need = ~is_unique
    clamped = torch.clamp(cost, max=max_distance + 1e-5)
    d2t = matching_forced(clamped, row_mask, col_mask, need, batched=batched)
    got = d2t >= 0
    safe = torch.where(got, d2t, 0).long()
    keep = got & (_take_cols(cost, safe) <= max_distance)
    slow = torch.where(keep, d2t, -1)
    if batched:
        return slow
    return torch.where(is_unique[:, None], fast_r2c, slow)


@_one_or_many
def greedy_unique_match(score, row_mask, col_mask, threshold):
    """The reference fast path: threshold the similarity matrix and accept
    it directly when it forms a (partial) unique matching (mirrors
    oc_sort/association.py:267-271). Returns (is_unique: bool per problem,
    row2col: int32 with -1 unmatched); row2col only means something
    where ``is_unique``."""
    valid = row_mask[:, :, None] & col_mask[:, None, :]
    a = (score > threshold) & valid
    rows_ok = a.sum(dim=2).amax(dim=1) == 1
    cols_ok = a.sum(dim=1).amax(dim=1) == 1
    is_unique = rows_ok & cols_ok
    row2col = torch.where(a.any(dim=2), _argmax_first(a, 2), -1)
    return is_unique, row2col
