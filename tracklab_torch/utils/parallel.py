"""Order-preserving host map over threads or processes (counterpart of
tracklab_tpu.utils.parallel). Process workers are spawned, not forked: the
parent may hold a CUDA context and run threads, which a forked child must
not inherit. Every call site is host work (per-sequence evaluation,
rendering)."""
from __future__ import annotations

from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

__all__ = ["parallel_map"]


def parallel_map(fn, items, num_workers: int, backend: str = "thread"):
    """``list(map(fn, items))`` in parallel. ``backend``: "thread"
    (default), "process" (spawned workers; ``fn`` and ``items`` must
    pickle, so ``fn`` is a module-level function) or "serial"."""
    items = list(items)
    if backend not in ("thread", "process", "serial"):
        raise ValueError(f"unknown parallel backend {backend!r}")
    if backend == "serial" or num_workers <= 1 or len(items) <= 1:
        return [fn(it) for it in items]
    n = min(num_workers, len(items))
    if backend == "process":
        import multiprocessing as mp
        with ProcessPoolExecutor(
                n, mp_context=mp.get_context("spawn")) as pool:
            return list(pool.map(fn, items))
    with ThreadPoolExecutor(n) as pool:
        return list(pool.map(fn, items))
