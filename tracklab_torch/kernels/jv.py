"""K1: the JV assignment kernel (``csrc/jv.cu``) and its plain version.

Replaces the Pallas TPU kernel ``tracklab_tpu/ops/assignment_pallas.py``
(``_jv_kernel`` behind ``solve_square_pallas``). The CUDA kernel solves each
problem on one warp, several problems to a CTA: a lane holds a contiguous
run of ceil(S/32) columns in registers, and each path step's argmin is one
``redux.sync`` plus a ballot, with no block barrier. It is bound by the
latency of those dependent steps (K rows, each a chain of argmins), not by
bytes or operations. See the source note in ``csrc/jv.cu``.

``solve_square_batched`` is the wrapper: for CPU tensors it runs the plain
version, for CUDA tensors it launches the kernel (or raises). Its
``launches`` attribute counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["solve_square_batched", "solve_square_batched_plain",
           "_solve_square_plain"]


def _solve_square_plain(cost: torch.Tensor, stats: dict | None = None):
    """Exact min-cost perfect matching on a square (K, K) matrix; returns
    ``col2row`` (K,) int32. The torch form of ``_solve_square_lax``: rows in
    order, columns vectorised, lowest-index argmin on ties. ``stats``, when
    given, accumulates the number of shortest-path steps under "steps"."""
    K = cost.shape[0]
    assert cost.shape == (K, K)
    dev, dt = cost.device, cost.dtype
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    FREE = K
    u = torch.zeros(K + 1, dtype=dt, device=dev)
    v = torch.zeros(K + 1, dtype=dt, device=dev)
    p = [FREE] * (K + 1)           # col -> row, slot K is the virtual column
    steps = 0
    for i in range(K):
        p[K] = i
        minv = torch.full((K,), float("inf"), dtype=dt, device=dev)
        way = torch.full((K,), K, dtype=torch.int64, device=dev)
        used = torch.zeros(K + 1, dtype=torch.bool, device=dev)
        used_l = [False] * (K + 1)
        j0 = K
        while p[j0] != FREE:
            used[j0] = True
            used_l[j0] = True
            i0 = p[j0]
            cur = cost[i0] - u[i0] - v[:K]
            better = (cur < minv) & ~used[:K]
            minv = torch.where(better, cur, minv)
            way = torch.where(better, j0, way)
            reach = torch.where(used[:K], inf, minv)
            j1 = int(torch.argmin(reach))
            delta = reach[j1]
            rows = [p[j] for j in range(K + 1) if used_l[j]]
            idx = torch.tensor(rows, dtype=torch.int64, device=dev)
            u[idx] = u[idx] + delta
            v = torch.where(used, v - delta, v)
            minv = torch.where(used[:K], minv, minv - delta)
            j0 = j1
            steps += 1
        way_l = way.tolist()
        while j0 != K:
            j1 = way_l[j0]
            p[j0] = p[j1]
            j0 = j1
    if stats is not None:
        stats["steps"] = stats.get("steps", 0) + steps
    return torch.tensor(p[:K], dtype=torch.int32, device=dev)


def solve_square_batched_plain(cost, k_eff, active):
    """Plain version of the batched kernel: problem ``b`` solves the
    leading ``k_eff[b]`` square block of ``cost[b]`` when ``active[b]``;
    every other column reports -1. Returns (B, S) int32."""
    B, S, _ = cost.shape
    out = torch.full((B, S), -1, dtype=torch.int32, device=cost.device)
    ks, act = k_eff.tolist(), active.tolist()
    for b in range(B):
        k = int(ks[b])
        if act[b] and k > 0:
            out[b, :k] = _solve_square_plain(cost[b, :k, :k])
    return out


@functools.cache
def _lib():
    from tracklab_torch.kernels._build import load

    lib = load("jv")
    fn = lib.tl_jv_solve_batched
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tl_jv_max_size.restype = ctypes.c_int
    return lib


def solve_square_batched(cost: torch.Tensor, k_eff: torch.Tensor,
                         active: torch.Tensor) -> torch.Tensor:
    """Batched exact assignment. ``cost`` (B, S, S) float, ``k_eff`` (B,)
    int32, ``active`` (B,) bool. Returns ``col2row`` (B, S) int32 with -1
    past ``k_eff[b]`` and everywhere for inactive problems.

    CPU tensors run :func:`solve_square_batched_plain`. CUDA tensors launch
    the kernel, which takes f32 and S <= 128, with no host sync."""
    if cost.dim() != 3 or cost.shape[1] != cost.shape[2]:
        raise ValueError(f"cost must be (B, S, S), got {tuple(cost.shape)}")
    B, S = cost.shape[0], cost.shape[1]
    if k_eff.shape != (B,) or active.shape != (B,):
        raise ValueError("k_eff and active must be (B,)")
    if not cost.is_cuda:
        return solve_square_batched_plain(cost, k_eff, active)
    if cost.dtype != torch.float32 or k_eff.dtype != torch.int32 \
            or active.dtype != torch.bool:
        raise TypeError("K1 takes f32 cost, int32 k_eff and bool active")
    if not (k_eff.device == active.device == cost.device):
        raise ValueError("cost, k_eff and active must share one device")
    lib = _lib()
    if S > lib.tl_jv_max_size():
        raise ValueError(f"K1 supports S <= {lib.tl_jv_max_size()}, got {S}")
    cost, k_eff, active = (cost.contiguous(), k_eff.contiguous(),
                           active.contiguous())
    out = torch.empty((B, S), dtype=torch.int32, device=cost.device)
    stream = torch.cuda.current_stream(cost.device).cuda_stream
    with torch.cuda.device(cost.device):
        err = lib.tl_jv_solve_batched(cost.data_ptr(), k_eff.data_ptr(),
                                      active.data_ptr(), out.data_ptr(),
                                      B, S, stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    solve_square_batched.launches += 1
    return out


solve_square_batched.launches = 0
