"""Multi-process execution: a ``torch.distributed`` process group and
per-process feeding of the frame batch.

Counterpart of `ft_fsd_path_planning_tpu/parallel/distributed.py`. Planning
is data-parallel over frames, so every process runs the same batched step on
its own rows of the global batch and only the batch metrics cross processes
(one ``all_reduce``, `parallel/batch.py::sharded_batched_step`). Where the
JAX package spans a device mesh over hosts, one process here drives one
device: the mesh is the process group, and a process's shard is its rows.

Backends: ``nccl`` between processes on different cards, ``gloo`` on the
CPU or for several processes on one card, which NCCL refuses. Nothing falls
back: a group that cannot be formed raises.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from ft_fsd_path_planning_torch.config import PlannerConfig
from ft_fsd_path_planning_torch.models.planner import PlannerState
from ft_fsd_path_planning_torch.parallel.batch import (
    Mesh,
    all_reduce_sum,
    leading_rows,
    make_batch_state,
    make_mesh,
    rank_device,
    tree_map,
)


def initialize_distributed(
    init_method: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device: str | torch.device | None = None,
) -> None:
    """Form the process group (idempotent: returns at once if it exists).

    With no arguments the rendezvous, world size and rank come from the
    environment ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``); explicit arguments name them, as
    ``init_method="tcp://localhost:<port>"``. The backend defaults to
    ``nccl`` when this process's device (`batch.rank_device`, default
    ``cuda``) is a CUDA device and to ``gloo`` on the CPU; ask for ``gloo``
    to put several processes on one card."""
    if dist.is_initialized():
        return
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs: dict[str, Any] = {"backend": backend, "init_method": init_method or "env://"}
    if num_processes is not None:
        kwargs.update(world_size=num_processes, rank=process_id)
    dist.init_process_group(**kwargs)


def global_mesh(axis: str = "data", device: str | torch.device | None = None) -> Mesh:
    """The mesh over every process of the group (one device each), or over
    this process alone when no group was formed."""
    return make_mesh(None, axis, device)


def host_local_slice(global_batch: int) -> tuple[int, int]:
    """[start, stop) rows of the global batch this process owns: an equal
    split by rank; ``(0, global_batch)`` without a group."""
    n, i = (dist.get_world_size(), dist.get_rank()) if dist.is_initialized() else (1, 0)
    if global_batch % n != 0:
        raise ValueError(
            f"global_batch={global_batch} must divide evenly over "
            f"{n} processes (pad the batch to a multiple)"
        )
    per = global_batch // n
    return i * per, (i + 1) * per


def make_global_batch(mesh: Mesh, local_tree: Any, global_batch: int) -> Any:
    """This process's rows of the global batch, on its device.

    ``local_tree`` (nested NamedTuples of numpy arrays or tensors) holds only
    the rows this process loaded, leading dim = its share: no process ever
    holds the whole batch. One ``all_reduce`` checks that the shares add up
    to ``global_batch``."""
    local = tree_map(lambda x: torch.as_tensor(x, device=mesh.device), local_tree)
    total = int(all_reduce_sum(mesh, torch.tensor([float(leading_rows(local))]))[0])
    if total != global_batch:
        raise ValueError(f"the processes' rows add up to {total}, not global_batch={global_batch}")
    return local


def make_global_state(cfg: PlannerConfig, mesh: Mesh, global_batch: int) -> PlannerState:
    """The initial planner state of this process's rows, on its device."""
    if global_batch % mesh.size != 0:
        raise ValueError(
            f"global_batch={global_batch} must divide evenly over "
            f"{mesh.size} processes (pad the batch to a multiple)"
        )
    return make_batch_state(cfg, global_batch // mesh.size, mesh.device)
