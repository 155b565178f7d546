"""Carry state and frames over from the JAX package.

The planner has no weights; what carries over between the two packages is
the planner state (previous path, relocalization transform, global path)
and the frame input. These functions take the JAX package's ``PlannerState``
or ``FrameInput`` whose leaves the caller has already turned into numpy
arrays, read them by attribute only (no JAX import), and return the port's
NamedTuples on ``device`` (default ``cuda``; raises without a GPU unless
``device="cpu"``). Unbatched inputs gain a batch axis of one.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ft_fsd_path_planning_torch.device import resolve_device
from ft_fsd_path_planning_torch.models.pathing import GlobalPathBuffer, PathState
from ft_fsd_path_planning_torch.models.planner import FrameInput, PlannerState
from ft_fsd_path_planning_torch.models.relocalization import RelocState


def _leaf(x: Any, ndim: int, device: torch.device) -> torch.Tensor:
    """``x`` as a tensor with ``ndim`` dimensions, a batch axis added to an
    unbatched leaf."""
    arr = np.asarray(x)
    if arr.ndim == ndim - 1:
        arr = arr[None]
    if arr.ndim != ndim:
        raise ValueError(f"leaf has {arr.ndim} dimensions, expected {ndim - 1} or {ndim}")
    return torch.as_tensor(np.ascontiguousarray(arr), device=device)


def state_from_numpy(state: Any, device: str | torch.device | None = None) -> PlannerState:
    """The port's PlannerState from a JAX ``PlannerState`` of numpy leaves."""
    dev = resolve_device(device)
    p, r, g = state.path, state.reloc, state.global_path
    return PlannerState(
        path=PathState(
            prev_path=_leaf(p.prev_path, 3, dev),
            index_along_path=_leaf(p.index_along_path, 1, dev),
        ),
        reloc=RelocState(
            has_origin=_leaf(r.has_origin, 1, dev),
            origin_position=_leaf(r.origin_position, 2, dev),
            origin_direction=_leaf(r.origin_direction, 2, dev),
            relocalized=_leaf(r.relocalized, 1, dev),
            rotation=_leaf(r.rotation, 1, dev),
            translation=_leaf(r.translation, 2, dev),
            center=_leaf(r.center, 2, dev),
        ),
        global_path=GlobalPathBuffer(
            points=_leaf(g.points, 3, dev),
            n_valid=_leaf(g.n_valid, 1, dev),
            active=_leaf(g.active, 1, dev),
        ),
    )


def frame_from_numpy(frame: Any, device: str | torch.device | None = None) -> FrameInput:
    """The port's FrameInput from a JAX ``FrameInput`` of numpy leaves."""
    dev = resolve_device(device)
    return FrameInput(
        cones=_leaf(frame.cones, 3, dev),
        mask=_leaf(frame.mask, 2, dev),
        position=_leaf(frame.position, 2, dev),
        direction=_leaf(frame.direction, 2, dev),
    )
