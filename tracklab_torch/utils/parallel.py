"""Order-preserving host map over threads or processes (counterpart of
tracklab_tpu.utils.parallel). Process workers use ``fork`` and must not
touch CUDA: every call site is host work (per-sequence evaluation)."""
from __future__ import annotations

import logging
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

log = logging.getLogger(__name__)

__all__ = ["parallel_map"]


def parallel_map(fn, items, num_workers: int, backend: str = "thread"):
    """``list(map(fn, items))`` in parallel. ``backend``: "thread"
    (default), "process" (fork; ``fn`` must be a picklable module-level
    function) or "serial"."""
    items = list(items)
    if backend not in ("thread", "process", "serial"):
        raise ValueError(f"unknown parallel backend {backend!r}")
    if backend == "serial" or num_workers <= 1 or len(items) <= 1:
        return [fn(it) for it in items]
    n = min(num_workers, len(items))
    if backend == "process":
        import multiprocessing as mp
        try:
            ctx = mp.get_context("fork")
        except ValueError:  # no fork on this platform: threads
            log.warning("fork unavailable; using threads")
        else:
            with ProcessPoolExecutor(n, mp_context=ctx) as pool:
                return list(pool.map(fn, items))
    with ThreadPoolExecutor(n) as pool:
        return list(pool.map(fn, items))
