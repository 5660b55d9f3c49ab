"""Linear assignment in PyTorch (counterpart of tracklab_tpu.ops.assignment).

The exact Jonker-Volgenant core is :func:`solve_square`: the plain torch
solver on CPU tensors, kernel K1 (``kernels/jv.py``) on CUDA tensors.

The JAX package picks among fast paths and solve variants with
``lax.cond``. A Python ``if`` on a CUDA tensor would sync with the host on
every frame, so here every branch that is cheap is computed and the result
is selected with ``torch.where``; the one expensive branch, the JV solve,
is a single batched K1 launch whose per-problem ``active`` flag and
``k_eff`` size are set on the device. On CPU tensors the plain batched
solver reads those flags and skips inactive problems.

Capacity padding: callers pass full (R, C) cost matrices plus boolean
row/col validity masks; invalid slots are routed to absorbing edges that
never perturb the valid-block optimum.
"""
from __future__ import annotations

import torch

from tracklab_torch.kernels.jv import _solve_square_plain, solve_square_batched

__all__ = ["solve_square", "matching_forced", "greedy_unique_match",
           "_solve_square_plain", "_col2row_to_row2col"]


def solve_square(cost: torch.Tensor) -> torch.Tensor:
    """Exact min-cost perfect matching on a square (K, K) float matrix.
    Returns ``col2row`` (K,) int32. All costs must be finite."""
    K = cost.shape[0]
    k = torch.full((1,), K, dtype=torch.int32, device=cost.device)
    on = torch.ones(1, dtype=torch.bool, device=cost.device)
    return solve_square_batched(cost[None], k, on)[0]


def _col2row_to_row2col(col2row: torch.Tensor, n_rows_total: int):
    """Invert a col->row map into row->col (rows outside get -1)."""
    K = col2row.shape[0]
    dev = col2row.device
    row2col = torch.full((n_rows_total + 1,), -1, dtype=torch.int32,
                         device=dev)
    cols = torch.arange(K, dtype=torch.int32, device=dev)
    ok = (col2row >= 0) & (col2row < n_rows_total)
    safe_rows = torch.where(ok, col2row, n_rows_total).long()
    row2col.scatter_(0, safe_rows, cols)
    return row2col[:n_rows_total]


def _argmax_first(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 when none), int32."""
    return torch.argmax(mask.to(torch.int32), dim=dim).to(torch.int32)


def matching_forced(cost, row_mask, col_mask, need=None):
    """scipy-style forced rectangular matching on a padded matrix.

    Matches every valid row/col up to min(#valid rows, #valid cols),
    minimizing total cost on the valid block. Costs are normalized to
    [-1, 1] and shifted by -2 on the valid-valid block; every edge touching
    an invalid slot costs 0, so every optimum has maximum valid-valid
    cardinality and is optimal on the valid block.

    The strict-argmin fast paths (each valid row's, or column's, masked
    minimum is unique and the argmins are distinct) give the unique optimum
    without a solve. ``need`` is an optional device bool: False means the
    caller discards the result, so the JV solve is skipped (K1 exits at
    once). Returns row2col (R,) int32: the matched valid column per valid
    row, else -1.
    """
    R, C = cost.shape
    dev = cost.device
    inf = torch.full((), float("inf"), dtype=cost.dtype, device=dev)
    valid = row_mask[:, None] & col_mask[None, :]
    feas = torch.where(valid & torch.isfinite(cost), cost, inf)
    nR = row_mask.sum(dtype=torch.int32)
    nC = col_mask.sum(dtype=torch.int32)
    ar_c = torch.arange(C, dtype=torch.int32, device=dev)
    ar_r = torch.arange(R, dtype=torch.int32, device=dev)

    rmin = feas.amin(dim=1)
    ramin = torch.argmin(feas, dim=1).to(torch.int32)
    r_strict = ((feas == rmin[:, None]).sum(dim=1) == 1) & torch.isfinite(rmin)
    r_hot = (ramin[:, None] == ar_c[None, :]) & (row_mask & r_strict)[:, None]
    row_fast_ok = ((nR <= nC) & torch.all(r_strict | ~row_mask)
                   & torch.all(r_hot.sum(dim=0) <= 1))

    cmin = feas.amin(dim=0)
    camin = torch.argmin(feas, dim=0).to(torch.int32)
    c_strict = ((feas == cmin[None, :]).sum(dim=0) == 1) & torch.isfinite(cmin)
    c_hot = (camin[None, :] == ar_r[:, None]) & (col_mask & c_strict)[None, :]
    col_fast_ok = ((nC < nR) & torch.all(c_strict | ~col_mask)
                   & torch.all(c_hot.sum(dim=1) <= 1))

    row_fast = torch.where(row_mask & r_strict, ramin, -1)
    col_fast = torch.where(c_hot.any(dim=1), _argmax_first(c_hot, 1), -1)

    slow_need = ~(row_fast_ok | col_fast_ok)
    if need is not None:
        slow_need = slow_need & need
    slow = _matching_forced_jv(cost, row_mask, col_mask, slow_need)
    return torch.where(row_fast_ok, row_fast,
                       torch.where(col_fast_ok, col_fast, slow))


def _forced_prep(cost, row_mask, col_mask):
    """The absorbing-edge square of ``_forced_core``: returns the (S, S)
    matrix (S = max(R, C)) and the finite-and-valid mask."""
    R, C = cost.shape
    S = max(R, C)
    valid = row_mask[:, None] & col_mask[None, :]
    finite = torch.isfinite(cost) & valid
    zero = torch.zeros((), dtype=cost.dtype, device=cost.device)
    scale = torch.clamp(torch.where(finite, cost.abs(), zero).amax(),
                        min=1e-9)
    c_hat = torch.clamp(torch.where(finite, cost, zero) / scale,
                        -1.0, 1.0) - 2.0
    sq = torch.zeros((S, S), dtype=cost.dtype, device=cost.device)
    sq[:R, :C] = torch.where(valid, c_hat, zero)
    return sq, finite


def _forced_finish(col2row, finite, row_mask, col_mask):
    """Strip pairs that used absorbing edges or invalid slots."""
    R, C = finite.shape
    row2col = _col2row_to_row2col(col2row, R)
    cols_ok = (row2col >= 0) & (row2col < C)
    safe_col = torch.where(cols_ok, row2col, 0).long()
    ar = torch.arange(R, device=finite.device)
    pair_valid = (cols_ok & row_mask & col_mask[safe_col]
                  & finite[ar, safe_col])
    return torch.where(pair_valid, row2col, -1)


def _forced_core(cost, row_mask, col_mask, need):
    """Forced matching through one square solve (no compaction), skipped
    on the device when ``need`` is False."""
    sq, finite = _forced_prep(cost, row_mask, col_mask)
    k = torch.full((1,), sq.shape[0], dtype=torch.int32, device=cost.device)
    c2r = solve_square_batched(sq[None], k, need.reshape(1))[0]
    return _forced_finish(c2r, finite, row_mask, col_mask)


def _permute_cols_like_onehot_matmul(cost, colmap):
    """``cost @ onehot`` for the one-hot column permutation ``colmap``,
    as a gather that keeps the product's IEEE semantics: a non-finite entry
    elsewhere in a row turns the whole permuted row into NaN (inf * 0)."""
    g = cost[:, colmap]
    n_bad = (~torch.isfinite(cost)).sum(dim=1, keepdim=True)
    other_bad = (n_bad - (~torch.isfinite(g)).to(n_bad.dtype)) > 0
    return torch.where(other_bad, torch.full_like(g, float("nan")), g)


def _matching_forced_jv(cost, row_mask, col_mask, need):
    """The JV solve path of :func:`matching_forced`, as ONE batched K1
    launch. When C > R and at most R columns are valid, the valid columns
    are permuted to the front and the (R, R) block is solved instead of the
    (C, C) square (column compaction); ``k_eff`` selects which on the
    device."""
    R, C = cost.shape
    if C <= R:
        return _forced_core(cost, row_mask, col_mask, need)
    dev = cost.device
    sq_full, fin_full = _forced_prep(cost, row_mask, col_mask)
    S = sq_full.shape[0]

    col_i = col_mask.to(torch.int32)
    n_act = col_i.sum(dtype=torch.int32)
    rank_a = torch.cumsum(col_i, 0, dtype=torch.int32) - 1
    rank_i = torch.cumsum(1 - col_i, 0, dtype=torch.int32) - 1
    pos = torch.where(col_mask, rank_a, n_act + rank_i)       # (C,) perm
    colmap = torch.empty(C, dtype=torch.int64, device=dev)
    colmap.scatter_(0, pos.long(), torch.arange(C, device=dev))
    perm_cost = _permute_cols_like_onehot_matmul(cost, colmap)
    perm_mask = col_mask[colmap]
    sq_small, fin_small = _forced_prep(perm_cost[:, :R], row_mask,
                                       perm_mask[:R])

    small = n_act <= R
    sq = sq_full.clone()
    sq[:R, :R] = torch.where(small, sq_small, sq_full[:R, :R])
    k = torch.where(small, R, S).to(torch.int32).reshape(1)
    c2r = solve_square_batched(sq[None], k, need.reshape(1))[0]

    r2c = _forced_finish(c2r[:R], fin_small, row_mask, perm_mask[:R])
    ok = r2c >= 0
    r2c_small = torch.where(ok, colmap[torch.where(ok, r2c, 0).long()]
                            .to(torch.int32), -1)
    r2c_full = _forced_finish(c2r, fin_full, row_mask, col_mask)
    return torch.where(small, r2c_small, r2c_full)


def greedy_unique_match(score, row_mask, col_mask, threshold):
    """The reference fast path: threshold the similarity matrix and accept
    it directly when it forms a (partial) unique matching (mirrors
    oc_sort/association.py:267-271). Returns (is_unique: bool tensor,
    row2col: (R,) int32 with -1 unmatched); row2col only means something
    when ``is_unique``."""
    valid = row_mask[:, None] & col_mask[None, :]
    a = (score > threshold) & valid
    rows_ok = a.sum(dim=1).amax() == 1
    cols_ok = a.sum(dim=0).amax() == 1
    is_unique = rows_ok & cols_ok
    row2col = torch.where(a.any(dim=1), _argmax_first(a, 1), -1)
    return is_unique, row2col
