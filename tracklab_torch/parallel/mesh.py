"""Multi-device parallelism over a process group (counterpart of
tracklab_tpu.parallel.mesh).

The torch idiom is one process per card: a ``torch.distributed`` process
group (NCCL on the cards, gloo on the CPU) and a ``DeviceMesh`` over its
ranks, of shape (dp, tp):

* **video-dp**, the workload's own outer axis: videos are independent, so
  :func:`tracker_videos_sharded` gives each rank its contiguous V / n
  videos, runs them through the port's ``*_scan_videos`` with no
  communication, and all-gathers the outputs to (V, ...) on every rank
  (the JAX package returns one global array);
* **dp** / **tp** for the models: :func:`shard_batch_dp` shards a batch's
  leading axis over dp (``DTensor`` ``Shard(0)``), :func:`shard_params_tp`
  shards large weights' output channels (dim 0 in torch's layout, the last
  dim in flax's) over tp.

``make_mesh`` with no process group creates one: from ``torchrun``'s
environment when it names more than one process, else a one-rank group on
an in-process store (nothing leaves the process), NCCL on the card and
gloo on the CPU. One card runs world size 1; ``torchrun --nproc-per-node
N`` runs N. :func:`release_process_group` destroys the group this module
made.
"""
from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.distributed as dist

from tracklab_torch.device import resolve_device

__all__ = ["make_mesh", "shard_params_tp", "shard_batch_dp",
           "tracker_videos_sharded", "initialize_multihost",
           "ensure_process_group", "release_process_group", "mesh_axis",
           "mesh_device", "gather_videos", "tree_map", "stack_trees"]

_OWN_GROUP = False   # whether ensure_process_group created the group


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def ensure_process_group(device=None) -> bool:
    """Create the default process group when there is none: from
    ``torchrun``'s environment (``WORLD_SIZE`` > 1), else a one-rank group
    on an in-process ``HashStore``; NCCL for ``cuda``, gloo for the CPU.
    Returns whether it created one."""
    global _OWN_GROUP
    if dist.is_initialized():
        return False
    backend = _backend(resolve_device(device))
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    _OWN_GROUP = True
    return True


def release_process_group():
    """Destroy the default process group if :func:`ensure_process_group`
    created it."""
    global _OWN_GROUP
    if _OWN_GROUP and dist.is_initialized():
        dist.destroy_process_group()
    _OWN_GROUP = False


def make_mesh(n_devices: int | None = None,
              axis_names: Sequence[str] = ("dp", "tp"),
              tp_size: int | None = None, device=None):
    """A ``DeviceMesh`` of shape (dp, tp) over the first ``n_devices``
    ranks (all of them by default) on ``device``'s type (``cuda`` unless
    told otherwise). ``tp_size`` defaults to 2 where the count is even and
    at least 2, else 1 (the JAX package's rule). ``n_devices`` beyond the
    world size raises ValueError."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    ensure_process_group(dev)
    world = dist.get_world_size()
    n = int(n_devices) if n_devices else world
    if n > world:
        raise ValueError(f"make_mesh: {n} devices asked for, but the "
                         f"process group has {world} ranks")
    if tp_size is None:
        tp_size = 2 if n % 2 == 0 and n >= 2 else 1
    if n % tp_size:
        raise ValueError(f"make_mesh: {n} devices do not split into tp "
                         f"groups of {tp_size}")
    ranks = torch.arange(n).reshape(n // tp_size, tp_size)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(axis_names))


def mesh_axis(mesh, axis: str):
    """(process group, size, this rank's index) of ``mesh``'s ``axis``."""
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh axes are {mesh.mesh_dim_names}, not "
                         f"{axis!r}")
    dim = mesh.mesh_dim_names.index(axis)
    return (mesh.get_group(dim), mesh.size(dim),
            mesh.get_local_rank(dim))


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def tree_map(fn, tree):
    """``fn`` on every tensor of a tree of tuples (named too), lists and
    dicts; None and other leaves pass through."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def stack_trees(trees):
    """Trees of equal structure -> one tree whose tensors are stacked on a
    new leading axis (None stays None)."""
    first = trees[0]
    if torch.is_tensor(first):
        return torch.stack(trees)
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(stack_trees(list(x)) for x in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(stack_trees(list(x)) for x in zip(*trees))
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return first


def gather_videos(tree, group, n: int):
    """All-gather every tensor of ``tree`` over ``group`` (``n`` ranks)
    along its leading axis: each rank's (k, ...) shard -> (n k, ...) on
    every rank, in rank order. The identity for one rank."""
    if n == 1:
        return tree

    def gather(x):
        src = x.contiguous()
        if src.dtype == torch.bool:
            src = src.to(torch.uint8)
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts).to(x.dtype)

    return tree_map(gather, tree)


def _leading(tree):
    found = []
    tree_map(lambda x: found.append(x.shape[0]), tree)
    return found[0]


def tracker_videos_sharded(scan_fn, cfg, mesh, axis: str = "dp"):
    """A multi-video tracker over ``mesh``'s ``axis``: ``run(*inputs)``
    takes the scan's inputs with a leading video axis V (a Detections and
    tensors, as ``*_scan_videos`` takes them); each rank runs its
    contiguous V / n videos through ``scan_fn(cfg, *inputs)`` on its own
    device with no communication, and the (final_state, outputs) are
    all-gathered to (V, ...) on every rank. V must be a multiple of the
    axis size."""
    group, n, r = mesh_axis(mesh, axis)
    dev = mesh_device(mesh)

    def run(*inputs):
        V = _leading(inputs)
        if V % n:
            raise ValueError(f"V ({V}) must be a multiple of "
                             f"mesh.shape[{axis!r}] ({n})")
        k = V // n
        local = tree_map(lambda x: x[r * k:(r + 1) * k].to(dev), inputs)
        return gather_videos(scan_fn(cfg, *local), group, n)

    return run


def _placements(mesh, sharded: dict):
    from torch.distributed.tensor import Replicate

    out = [Replicate()] * mesh.ndim
    for axis, p in sharded.items():
        out[mesh.mesh_dim_names.index(axis)] = p
    return out


def shard_params_tp(params, mesh, min_channels: int = 64):
    """Distribute a tree of weights (a state dict, say) over ``mesh``:
    weights of 2 or more dims whose output channels (dim 0) number at
    least ``min_channels`` and divide by the tp size are ``Shard(0)`` over
    ``tp``; the rest are replicated. Returns the tree of ``DTensor``s."""
    from torch.distributed.tensor import Shard, distribute_tensor

    tp = mesh.size(mesh.mesh_dim_names.index("tp"))

    def rule(t):
        if t.dim() >= 2 and t.shape[0] >= min_channels \
                and t.shape[0] % tp == 0:
            return distribute_tensor(t, mesh, _placements(
                mesh, {"tp": Shard(0)}))
        return distribute_tensor(t, mesh, _placements(mesh, {}))

    return tree_map(rule, params)


def shard_batch_dp(batch, mesh):
    """Distribute every tensor of ``batch`` over ``mesh``: its leading axis
    ``Shard(0)`` over ``dp``, replicated over the other axes."""
    from torch.distributed.tensor import Shard, distribute_tensor

    return tree_map(lambda t: distribute_tensor(
        t, mesh, _placements(mesh, {"dp": Shard(0)})), batch)


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None, device=None) -> bool:
    """Join a process group of ``num_processes`` (one per card, over hosts
    too): ``init_process_group`` at ``tcp://<coordinator_address>`` (or
    ``torchrun``'s environment when no address is given) with this
    ``process_id`` as its rank. A no-op returning False for one process or
    none."""
    if num_processes in (None, 0, 1):
        return False
    backend = _backend(resolve_device(device))
    if coordinator_address is None:
        dist.init_process_group(backend, world_size=num_processes,
                                rank=process_id)
    else:
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    return True
