"""Batched, replayed and sharded execution.

Counterpart of `ft_fsd_path_planning_tpu/parallel/batch.py`. The planner
step is already batched over a leading frame axis, so `batched_step` is one
call of it; `replay_scan` carries the state through time in a Python loop.
`sharded_batched_step` runs it on this process's rows of a batch split over
the processes of a ``torch.distributed`` group (`parallel/distributed.py`),
one device a process, and reduces the batch metrics across them.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from ft_fsd_path_planning_torch.config import PlannerConfig
from ft_fsd_path_planning_torch.device import resolve_device
from ft_fsd_path_planning_torch.models.planner import (
    FrameInput,
    PlannerState,
    StepOutput,
    make_initial_state,
    planner_step,
)

Tensor = torch.Tensor


def make_batch_state(
    cfg: PlannerConfig, batch: int, device: str | torch.device | None = None
) -> PlannerState:
    """The initial planner state repeated over a batch axis, on ``device``
    (default ``cuda``; raises without a GPU unless ``device="cpu"``)."""
    return make_initial_state(cfg, batch, device)


def batched_step(
    cfg: PlannerConfig, states: PlannerState, frames: FrameInput
) -> tuple[StepOutput, PlannerState]:
    """(B, ...) states x (B, ...) frames -> (outputs, new states)."""
    return planner_step(cfg, states, frames)


def replay_scan(
    cfg: PlannerConfig, state: PlannerState, frames: FrameInput
) -> tuple[PlannerState, Tensor]:
    """Run frame sequences through the planner, carrying state. ``frames``
    has a leading time axis before the batch axis, (T, B, ...); returns
    (final_state, (T, B, H, 4) paths)."""
    paths = []
    for t in range(frames.cones.shape[0]):
        out, state = planner_step(cfg, state, FrameInput(*(x[t] for x in frames)))
        paths.append(out.path)
    return state, torch.stack(paths)


def batched_replay(
    cfg: PlannerConfig, states: PlannerState, frames: FrameInput
) -> tuple[PlannerState, Tensor]:
    """(B, T, ...) frame batches, each lane its own scenario with its own
    carried state; returns (final_states, (B, T, H, 4) paths). The step is
    batched already, so this is `replay_scan` over the transposed frames."""
    final, paths = replay_scan(cfg, states, FrameInput(*(x.transpose(0, 1) for x in frames)))
    return final, paths.transpose(0, 1)


class BatchMetrics(NamedTuple):
    """Per-batch aggregate metrics: solve success, fallback-path rate and
    the shape statistics a race engineer watches during a run."""

    n_frames: Tensor
    mean_path_length: Tensor
    mean_abs_curvature: Tensor
    # fraction of frames whose path came out of the full solve
    solve_success_rate: Tensor
    # fraction of frames where the overwrite-if-too-far guard fired
    too_far_rate: Tensor
    # fraction of relocalized frames (skidpad/accel missions)
    relocalized_rate: Tensor
    # fraction of frames where a FITPACK fit exited on its knot budget
    spline_budget_hit_rate: Tensor


def batch_metrics(outs: StepOutput) -> BatchMetrics:
    paths = outs.path
    mean = lambda v: torch.mean(v.to(torch.float32))  # noqa: E731
    return BatchMetrics(
        n_frames=torch.tensor(float(paths.shape[0]), device=paths.device),
        mean_path_length=mean(paths[:, -1, 0]),
        mean_abs_curvature=mean(torch.mean(torch.abs(paths[:, :, 3]), dim=1)),
        solve_success_rate=mean(outs.path_ok),
        too_far_rate=mean(outs.path_too_far),
        relocalized_rate=mean(outs.relocalized),
        spline_budget_hit_rate=mean(outs.spline_budget_hit),
    )


def _point_to_polyline_dist(a: Tensor, ref_xy: Tensor) -> Tensor:
    """(B, H, 2) query points vs (B, R, 2) polylines -> (B, H) distances
    (point-to-segment)."""
    p0 = ref_xy[:, :-1, :]
    seg = ref_xy[:, 1:, :] - p0
    seg_len2 = torch.clamp(torch.sum(seg * seg, dim=-1), min=1e-12)
    rel = a[:, :, None, :] - p0[:, None, :, :]
    t = torch.clamp(torch.sum(rel * seg[:, None], dim=-1) / seg_len2[:, None, :], 0.0, 1.0)
    foot = p0[:, None] + t[..., None] * seg[:, None]
    d2 = torch.sum((a[:, :, None, :] - foot) ** 2, dim=-1)
    return torch.sqrt(torch.amin(d2, dim=-1))


def path_deviation(paths: Tensor, ref_xy: Tensor) -> Tensor:
    """Per-frame max lateral deviation of (B, H, 4) paths vs (B, R, 2)
    reference polylines."""
    return _point_to_polyline_dist(paths[:, :, 1:3], ref_xy).amax(dim=-1)


def path_parity_deviation_paths(a_paths: Tensor, b_paths: Tensor) -> Tensor:
    """Symmetric per-frame deviation between two (B, H, 4) path stacks over
    their common arc span: the 20 m trim can flip the final sample between
    builds, so query points past the common theta span are excluded and the
    target curves kept whole."""
    d_ab = _point_to_polyline_dist(a_paths[:, :, 1:3], b_paths[:, :, 1:3])
    d_ba = _point_to_polyline_dist(b_paths[:, :, 1:3], a_paths[:, :, 1:3])
    span = torch.minimum(a_paths[:, -1, 0], b_paths[:, -1, 0]) + 1e-6
    d_ab = torch.where(a_paths[:, :, 0] <= span[:, None], d_ab, torch.zeros_like(d_ab))
    d_ba = torch.where(b_paths[:, :, 0] <= span[:, None], d_ba, torch.zeros_like(d_ba))
    return torch.maximum(d_ab.amax(dim=-1), d_ba.amax(dim=-1))


# ---------------------------------------------------------------------------
# sharding over processes
# ---------------------------------------------------------------------------


class Mesh(NamedTuple):
    """Where this process's rows live: the process group (``None`` on one
    process without a group), this process's device and the batch axis's
    name. One process drives one device, so the mesh's size is the group's."""

    group: Any
    device: torch.device
    axis: str = "data"

    @property
    def size(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)


def rank_device(device: str | torch.device | None = None) -> torch.device:
    """This process's device: ``device`` as given, or by default the CUDA
    card of its local rank (``LOCAL_RANK`` modulo the cards); raises
    without a GPU unless the caller asks for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    return dev


def make_mesh(
    n_devices: int | None = None, axis: str = "data", device: str | torch.device | None = None
) -> Mesh:
    """The mesh over the processes of the default group (one device each),
    or over this process alone when no group was formed. ``n_devices``, if
    given, must be the number of processes."""
    group = dist.group.WORLD if dist.is_initialized() else None
    mesh = Mesh(group, rank_device(device), axis)
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"a mesh of {n_devices} devices needs {n_devices} processes; the group has {mesh.size}")
    return mesh


def all_reduce_sum(mesh: Mesh, values: Tensor) -> Tensor:
    """Sum of a small float32 vector over the processes of the mesh, returned
    on the host. NCCL reduces on this process's card, gloo on the host; with
    no group it is the vector itself."""
    if mesh.group is None:
        return values.cpu()
    on_card = dist.get_backend(mesh.group) == "nccl"
    buf = values.to(mesh.device if on_card else "cpu")
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.cpu()


def sharded_batched_step(cfg: PlannerConfig, mesh: Mesh):
    """The batched step on this process's rows: ``fn(states, frames) ->
    (outs, new_states, BatchMetrics)``. Each process solves its rows on its
    own device (planning is data-parallel over frames); one ``all_reduce``
    of the local count and the six local sums gives every process the same
    metrics of the whole batch (on the host), sum / count."""

    def step(states: PlannerState, frames: FrameInput):
        outs, new_states = batched_step(cfg, states, frames)
        paths = outs.path
        local = torch.stack([
            torch.full((), float(paths.shape[0]), device=paths.device),
            torch.sum(paths[:, -1, 0].to(torch.float32)),
            torch.sum(torch.mean(torch.abs(paths[:, :, 3]), dim=1).to(torch.float32)),
            torch.sum(outs.path_ok.to(torch.float32)),
            torch.sum(outs.path_too_far.to(torch.float32)),
            torch.sum(outs.relocalized.to(torch.float32)),
            torch.sum(outs.spline_budget_hit.to(torch.float32)),
        ])
        sums = all_reduce_sum(mesh, local)
        n = sums[0]
        metrics = BatchMetrics(n, *(sums[i] / n for i in range(1, 7)))
        return outs, new_states, metrics

    return step


def shard_batch(mesh: Mesh, tree):
    """This process's rows of a full batched tree (nested NamedTuples of
    tensors), on its device: an equal split of the leading axis by rank."""
    batch = leading_rows(tree)
    if batch % mesh.size != 0:
        raise ValueError(
            f"global_batch={batch} must divide evenly over {mesh.size} processes (pad the batch to a multiple)"
        )
    per = batch // mesh.size
    lo = mesh.rank * per
    return tree_map(lambda x: torch.as_tensor(x)[lo : lo + per].to(mesh.device), tree)


def tree_map(fn, tree):
    """``fn`` over the leaves of nested NamedTuples (a `FrameInput`, a
    `PlannerState`)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    return fn(tree)


def leading_rows(tree) -> int:
    """The batch rows of a batched tree: its first leaf's leading dim."""
    while isinstance(tree, tuple):
        tree = tree[0]
    return int(tree.shape[0])
