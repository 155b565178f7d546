"""Planner step — the composition of all stages, batched over frames.

Counterpart of `ft_fsd_path_planning_tpu/models/planner.py` (reference
`full_pipeline/full_pipeline.py:84-207`): (relocalize | sort -> match) ->
path calculation -> (transform back). Every tensor carries a leading batch
axis of independent frames, so one call is the JAX package's vmapped step.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ft_fsd_path_planning_torch.assets.known_paths import (
    BASE_ACCELERATION_PATH,
    BASE_SKIDPAD_PATH,
)
from ft_fsd_path_planning_torch.config import PlannerConfig
from ft_fsd_path_planning_torch.device import resolve_device
from ft_fsd_path_planning_torch.models import matching, pathing, relocalization, sorting
from ft_fsd_path_planning_torch.ops import geometry as geo
from ft_fsd_path_planning_torch.utils.cone_types import ConeTypes
from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes

Tensor = torch.Tensor

GLOBAL_PATH_BUFFER_LEN = 3072


class PlannerState(NamedTuple):
    path: pathing.PathState
    reloc: relocalization.RelocState
    global_path: pathing.GlobalPathBuffer  # user-set path (set_global_path)


class FrameInput(NamedTuple):
    cones: Tensor  # (B, N, 3) [x, y, color], color -1 on padding
    mask: Tensor  # (B, N)
    position: Tensor  # (B, 2)
    direction: Tensor  # (B, 2)


class StepOutput(NamedTuple):
    path: Tensor  # (B, H, 4)
    path_ok: Tensor  # (B,) False = fell back to the previous path
    path_too_far: Tensor  # (B,) overwrite-if-too-far guard fired
    relocalized: Tensor  # (B,) (always False for trackdrive/autocross)
    spline_budget_hit: Tensor  # (B,) a FITPACK fit hit its knot budget
    sorted_left: Tensor  # (B, L, 2)
    sorted_left_mask: Tensor
    sorted_right: Tensor
    sorted_right_mask: Tensor
    left_with_virtual: Tensor  # (B, S, 2)
    left_mask: Tensor
    right_with_virtual: Tensor
    right_mask: Tensor
    left_to_right: Tensor  # (B, S)
    right_to_left: Tensor


@functools.lru_cache(maxsize=8)
def _known_path_points(skidpad: bool, device: torch.device) -> tuple[Tensor, int]:
    """The fixed mission path in a (GLOBAL_PATH_BUFFER_LEN, 2) float32 buffer
    on ``device`` with its valid count, built once for each device."""
    path = BASE_SKIDPAD_PATH[::2] if skidpad else BASE_ACCELERATION_PATH
    buf = np.zeros((GLOBAL_PATH_BUFFER_LEN, 2), np.float32)
    n = min(len(path), GLOBAL_PATH_BUFFER_LEN)
    buf[:n] = path[:n]
    return torch.as_tensor(buf, device=device), n


def _known_global_path(cfg: PlannerConfig, active: Tensor) -> pathing.GlobalPathBuffer:
    """The fixed mission path loaded after relocalization
    (full_pipeline.py:134, skidpad_relocalizer.py:242-243), one view of the
    same buffer for every lane; ``active`` (B,) is per lane."""
    points, n = _known_path_points(cfg.mission == MissionTypes.skidpad, active.device)
    batch = active.shape[0]
    return pathing.GlobalPathBuffer(
        points=points[None].expand(batch, -1, -1),
        n_valid=torch.full((batch,), n, dtype=torch.int32, device=active.device),
        active=active,
    )


def make_initial_state(
    cfg: PlannerConfig, batch: int = 1, device: str | torch.device | None = None
) -> PlannerState:
    """Initial planner state for ``batch`` frames on ``device`` (default
    ``cuda``; raises without a GPU unless ``device="cpu"``)."""
    dev = resolve_device(device)
    return PlannerState(
        path=pathing.initial_path_state(cfg, batch, dev),
        reloc=relocalization.RelocState.initial(batch, dev),
        global_path=pathing.GlobalPathBuffer.empty(batch, GLOBAL_PATH_BUFFER_LEN, dev),
    )


def _pad_side(pts: Tensor, m: Tensor, s_len: int) -> tuple[Tensor, Tensor]:
    out = torch.zeros((pts.shape[0], s_len, 2), dtype=pts.dtype, device=pts.device)
    out_m = torch.zeros((m.shape[0], s_len), dtype=torch.bool, device=m.device)
    out[:, : pts.shape[1]] = pts
    out_m[:, : m.shape[1]] = m
    return out, out_m


def planner_step(
    cfg: PlannerConfig, state: PlannerState, frame: FrameInput
) -> tuple[StepOutput, PlannerState]:
    """One planner step for a batch of frames: (B, ...) state x (B, ...)
    frames -> (outputs, new state)."""
    return _planner_step_impl(cfg, state, frame, None)


def planner_step_presorted(
    cfg: PlannerConfig,
    state: PlannerState,
    frame: FrameInput,
    sorted_left: Tensor,  # (B, L, 2)
    sorted_left_mask: Tensor,  # (B, L)
    sorted_right: Tensor,
    sorted_right_mask: Tensor,
) -> tuple[StepOutput, PlannerState]:
    """Step variant that skips the beam-search sorter and reuses a previous
    frame's sorted cone order: the reference's
    `experimental_performance_improvements` sorting-result cache
    (core_trace_sorter.py:189-250, 298-301). When the facade's host-side
    similarity check passes, the cached order (remapped onto the current
    cone positions) is fed here and only matching and path calculation run."""
    if cfg.has_relocalizer:
        raise ValueError("presorted step only exists for the sorting pipeline")
    presorted = sorting.SortingOutput(
        left_cones=sorted_left,
        left_mask=sorted_left_mask,
        right_cones=sorted_right,
        right_mask=sorted_right_mask,
    )
    return _planner_step_impl(cfg, state, frame, presorted)


def _planner_step_impl(
    cfg: PlannerConfig,
    state: PlannerState,
    frame: FrameInput,
    presorted: sorting.SortingOutput | None,
) -> tuple[StepOutput, PlannerState]:
    s_len = cfg.shapes.side_len
    position, direction = frame.position, frame.direction

    if cfg.has_relocalizer:
        # relocalization replaces sorting and matching (full_pipeline.py:122-141)
        reloc = relocalization.attempt_relocalization(
            cfg, state.reloc, frame.cones[..., :2], frame.mask, position, direction
        )
        relocalized = reloc.relocalized
        yaw = geo.angle_from_2d_vector(direction)
        pos_t, yaw_t = relocalization.transform_to_known_frame(reloc, position, yaw)
        position = torch.where(relocalized[:, None], pos_t, position)
        direction = torch.where(relocalized[:, None], geo.unit_2d_vector_from_angle(yaw_t), direction)
        gp = _known_global_path(cfg, relocalized | state.global_path.active)

        batch, dev = position.shape[0], position.device
        empty_sorted = torch.zeros((batch, cfg.sorting.max_length, 2), device=dev)
        empty_side = torch.zeros((batch, s_len, 2), device=dev)
        empty_side_mask = torch.zeros((batch, s_len), dtype=torch.bool, device=dev)
        empty_matches = torch.full((batch, s_len), -1, dtype=torch.int32, device=dev)
        sort_out = sorting.SortingOutput(
            left_cones=empty_sorted, left_mask=empty_side_mask[:, : cfg.sorting.max_length],
            right_cones=empty_sorted, right_mask=empty_side_mask[:, : cfg.sorting.max_length],
        )
        match_out = matching.MatchingOutput(
            left_cones=empty_side, left_mask=empty_side_mask,
            left_virtual_mask=empty_side_mask,
            right_cones=empty_side, right_mask=empty_side_mask,
            right_virtual_mask=empty_side_mask,
            left_to_right=empty_matches, right_to_left=empty_matches,
        )
    else:
        reloc = state.reloc
        gp = state.global_path
        if presorted is None:
            mask = frame.mask
            if not cfg.sorting.use_unknown_cones:
                mask = mask & (frame.cones[..., 2] != ConeTypes.UNKNOWN)
            sort_out = sorting.run_cone_sorting(cfg, frame.cones, mask, position, direction)
        else:
            sort_out = presorted
        ml, mlm = _pad_side(sort_out.left_cones, sort_out.left_mask, s_len)
        mr, mrm = _pad_side(sort_out.right_cones, sort_out.right_mask, s_len)
        match_out = matching.run_cone_matching(
            cfg,
            matching.MatchingInput(
                left_cones=ml, left_mask=mlm, right_cones=mr, right_mask=mrm,
                position=position, direction=direction,
            ),
        )

    path_out = pathing.run_path_calculation(
        cfg,
        pathing.PathInput(
            left_cones=match_out.left_cones,
            left_mask=match_out.left_mask,
            right_cones=match_out.right_cones,
            right_mask=match_out.right_mask,
            left_to_right=match_out.left_to_right,
            right_to_left=match_out.right_to_left,
            position=position,
            direction=direction,
        ),
        gp,
        state.path,
    )

    final = path_out.path
    if cfg.has_relocalizer:
        # convert back to the original frame (full_pipeline.py:178-194)
        xy = final[:, :, 1:3]
        back, _ = relocalization.transform_to_original_frame(reloc, xy, torch.zeros_like(xy[..., 0]))
        moved = torch.cat([final[:, :, :1], back, final[:, :, 3:]], dim=2)
        final = torch.where(reloc.relocalized[:, None, None], moved, final)

    new_state = PlannerState(path=path_out.state, reloc=reloc, global_path=state.global_path)
    return (
        StepOutput(
            path=final,
            path_ok=path_out.ok,
            path_too_far=path_out.too_far,
            relocalized=reloc.relocalized,
            spline_budget_hit=path_out.spline_budget_hit,
            sorted_left=sort_out.left_cones,
            sorted_left_mask=sort_out.left_mask,
            sorted_right=sort_out.right_cones,
            sorted_right_mask=sort_out.right_mask,
            left_with_virtual=match_out.left_cones,
            left_mask=match_out.left_mask,
            right_with_virtual=match_out.right_cones,
            right_mask=match_out.right_mask,
            left_to_right=match_out.left_to_right,
            right_to_left=match_out.right_to_left,
        ),
        new_state,
    )
