"""K2: the batched rectangular JV kernel (``csrc/jv_rect.cu``) and its plain
version.

Replaces the Pallas TPU kernel ``tracklab_tpu/ops/assignment_pallas.py``
(``_jv_rect_batched_kernel`` behind ``solve_rect_batched_pallas``): V
independent exact assignments of all R rows of an (R, C) cost matrix,
R <= C, in one launch. The CUDA kernel solves each problem on one warp,
several problems to a CTA, with K1's design: a lane holds a contiguous run
of ceil(C/32) columns in registers, and each path step's argmin is one
``redux.sync`` plus a ballot, with no block barrier. Like K1 it is bound by
the latency of dependent steps (R rows, each a chain of argmins), not by
bytes. See the source note in ``csrc/jv_rect.cu``.

``solve_rect_batched`` is the wrapper: for CPU tensors it runs the plain
version, for CUDA tensors it launches the kernel (or raises). Its
``launches`` attribute counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["solve_rect_batched", "solve_rect_batched_plain",
           "_solve_rect_plain"]


def _solve_rect_plain(cost: torch.Tensor, stats: dict | None = None):
    """Exact min-cost assignment of all R rows of an (R, C) matrix, R <= C,
    to distinct columns; returns ``col2row`` (C,) int32 where the value R
    means the column is unassigned. The torch form of ``_solve_rect_lax``:
    rows in order, columns vectorised, lowest-index argmin on ties.
    ``stats``, when given, accumulates the shortest-path steps under
    "steps"."""
    R, C = cost.shape
    if R > C:
        raise ValueError(f"_solve_rect_plain needs R <= C, got {R} x {C}")
    dev, dt = cost.device, cost.dtype
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    FREE = R
    u = torch.zeros(R + 1, dtype=dt, device=dev)
    v = torch.zeros(C + 1, dtype=dt, device=dev)
    p = [FREE] * (C + 1)           # col -> row, slot C is the virtual column
    steps = 0
    for i in range(R):
        p[C] = i
        minv = torch.full((C,), float("inf"), dtype=dt, device=dev)
        way = torch.full((C,), C, dtype=torch.int64, device=dev)
        used = torch.zeros(C + 1, dtype=torch.bool, device=dev)
        used_cols = []
        j0 = C
        while p[j0] != FREE:
            used[j0] = True
            used_cols.append(j0)
            i0 = p[j0]
            cur = cost[i0] - u[i0] - v[:C]
            better = (cur < minv) & ~used[:C]
            minv = torch.where(better, cur, minv)
            way = torch.where(better, j0, way)
            reach = torch.where(used[:C], inf, minv)
            j1 = int(torch.argmin(reach))
            delta = reach[j1]
            idx = torch.tensor([p[j] for j in used_cols], dtype=torch.int64,
                               device=dev)
            u[idx] = u[idx] + delta
            v = torch.where(used, v - delta, v)
            minv = torch.where(used[:C], minv, minv - delta)
            j0 = j1
            steps += 1
        way_l = way.tolist()
        while j0 != C:
            j1 = way_l[j0]
            p[j0] = p[j1]
            j0 = j1
    if stats is not None:
        stats["steps"] = stats.get("steps", 0) + steps
    return torch.tensor(p[:C], dtype=torch.int32, device=dev)


def solve_rect_batched_plain(cost, active=None, stats: dict | None = None):
    """Plain version of the batched kernel: problem ``v`` solves
    ``cost[v]`` when ``active[v]`` (all problems when ``active`` is None);
    an inactive problem reports every column unassigned (value R).
    Returns (V, C) int32."""
    V, R, C = cost.shape
    out = torch.full((V, C), R, dtype=torch.int32, device=cost.device)
    act = [True] * V if active is None else active.tolist()
    for b in range(V):
        if act[b]:
            out[b] = _solve_rect_plain(cost[b], stats)
    return out


@functools.cache
def _lib():
    from tracklab_torch.kernels._build import load

    lib = load("jv_rect")
    fn = lib.tl_jv_rect_solve_batched
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tl_jv_rect_max_cols.restype = ctypes.c_int
    return lib


def solve_rect_batched(cost: torch.Tensor,
                       active: torch.Tensor | None = None) -> torch.Tensor:
    """V independent exact rectangular assignments. ``cost`` (V, R, C)
    float with R <= C and finite entries, ``active`` optional (V,) bool.
    Returns ``col2row`` (V, C) int32; the value R marks an unassigned
    column, and every column of an inactive problem.

    CPU tensors run :func:`solve_rect_batched_plain`. CUDA tensors launch
    the kernel, which takes f32 and C <= 256, with no host sync."""
    if cost.dim() != 3:
        raise ValueError(f"cost must be (V, R, C), got {tuple(cost.shape)}")
    V, R, C = cost.shape
    if not 1 <= R <= C:
        raise ValueError(f"K2 needs 1 <= R <= C, got R={R}, C={C}")
    if active is not None and active.shape != (V,):
        raise ValueError("active must be (V,)")
    if not cost.is_cuda:
        return solve_rect_batched_plain(cost, active)
    if active is None:
        active = torch.ones(V, dtype=torch.bool, device=cost.device)
    if cost.dtype != torch.float32 or active.dtype != torch.bool:
        raise TypeError("K2 takes f32 cost and bool active")
    if active.device != cost.device:
        raise ValueError("cost and active must share one device")
    lib = _lib()
    if C > lib.tl_jv_rect_max_cols():
        raise ValueError(f"K2 supports C <= {lib.tl_jv_rect_max_cols()}, "
                         f"got {C}")
    cost, active = cost.contiguous(), active.contiguous()
    out = torch.empty((V, C), dtype=torch.int32, device=cost.device)
    stream = torch.cuda.current_stream(cost.device).cuda_stream
    with torch.cuda.device(cost.device):
        err = lib.tl_jv_rect_solve_batched(cost.data_ptr(), active.data_ptr(),
                                           out.data_ptr(), V, R, C, stream)
    if err != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {err}")
    solve_rect_batched.launches += 1
    return out


solve_rect_batched.launches = 0
