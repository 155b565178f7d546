"""Batched and replayed execution on one device.

Counterpart of `ft_fsd_path_planning_tpu/parallel/batch.py`. The planner
step is already batched over a leading frame axis, so `batched_step` is one
call of it; `replay_scan` carries the state through time in a Python loop.
Multi-device sharding is not ported yet (ROADMAP.md, Queue A11).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ft_fsd_path_planning_torch.config import PlannerConfig
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
