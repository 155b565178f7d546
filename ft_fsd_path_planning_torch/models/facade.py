"""Public NumPy-in/NumPy-out facade — the reference `PathPlanner`
(full_pipeline/full_pipeline.py:53-217) on the PyTorch planner.

Counterpart of `ft_fsd_path_planning_tpu/models/facade.py` for the sorting
missions (trackdrive, autocross) without the sorting-result cache: the
facade pads ragged host inputs into the fixed shape budget, runs one batched
planner step with a batch of one on the device, and returns the path.
"""

from __future__ import annotations

import warnings
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from ft_fsd_path_planning_torch.config import PlannerConfig, default_config
from ft_fsd_path_planning_torch.device import resolve_device
from ft_fsd_path_planning_torch.models.planner import (
    FrameInput,
    make_initial_state,
    planner_step,
)
from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes

FloatArray = np.ndarray


def flatten_cones_by_type(
    cones: List[FloatArray], n_max: int, dtype=np.float32
) -> Tuple[np.ndarray, np.ndarray]:
    """Ravel the per-type cone lists into a padded (N, 3) [x, y, color]
    array + mask (reference flatten_cones_by_type_array). Warns when the
    frame overflows the ``n_max`` budget."""
    total = sum(np.asarray(c).reshape(-1, 2).shape[0] for c in cones)
    if total > n_max:
        warnings.warn(
            f"frame has {total} cones but the configured shape budget is "
            f"n_cones={n_max}; {total - n_max} cones will be DROPPED. "
            "Construct the planner with a larger budget, e.g. "
            "PathPlanner(mission, config=default_config(mission, n_cones=256)).",
            RuntimeWarning,
            stacklevel=2,
        )
    pts = np.zeros((n_max, 3), dtype)
    pts[:, 2] = -1.0
    mask = np.zeros(n_max, bool)
    start = 0
    for cone_type in range(len(cones)):
        arr = np.asarray(cones[cone_type], dtype).reshape(-1, 2)
        n = min(len(arr), n_max - start)
        pts[start : start + n, :2] = arr[:n]
        pts[start : start + n, 2] = cone_type
        mask[start : start + n] = True
        start += n
    return pts, mask


class PathPlanner:
    """The reference PathPlanner for trackdrive and autocross.

    Runs on ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"``). Not ported yet (ROADMAP.md, Queue A9/A10): the
    sorting cache (``experimental_performance_improvements=True``),
    ``set_global_path``, the relocalizer missions and
    ``return_intermediate_results``.
    """

    def __init__(
        self,
        mission: MissionTypes,
        experimental_performance_improvements: bool = False,
        config: Optional[PlannerConfig] = None,
        device: str | torch.device | None = None,
    ) -> None:
        self.mission = mission
        self.cfg = config or default_config(mission, experimental_performance_improvements)
        if self.cfg.has_relocalizer:
            raise NotImplementedError(
                "relocalizer missions are not ported yet (ROADMAP.md, Queue A10)"
            )
        if self.cfg.experimental_performance_improvements:
            raise NotImplementedError(
                "the sorting-result cache is not ported yet (ROADMAP.md, Queue A9)"
            )
        self.device = resolve_device(device)
        self._state = make_initial_state(self.cfg, 1, self.device)

    def _convert_direction_to_array(self, direction: Any) -> FloatArray:
        direction = np.squeeze(np.array(direction, float))
        if direction.shape == (2,):
            return direction
        if direction.shape in [(1,), ()]:
            return np.array([np.cos(float(direction)), np.sin(float(direction))])
        raise ValueError("direction must be a float or a 2 element array")

    def set_global_path(self, global_path: Optional[FloatArray]) -> None:
        raise NotImplementedError(
            "the global-path branch is not ported yet (ROADMAP.md, Queue A9)"
        )

    def calculate_path_in_global_frame(
        self,
        cones: List[FloatArray],
        vehicle_position: FloatArray,
        vehicle_direction: Union[FloatArray, float],
        return_intermediate_results: bool = False,
    ) -> FloatArray:
        """Run the full planning pipeline for one frame. Returns a (40, 4)
        array of (spline_parameter, x, y, curvature) waypoints."""
        if return_intermediate_results:
            raise NotImplementedError(
                "return_intermediate_results is not ported yet (ROADMAP.md, Queue A9)"
            )
        vehicle_direction = self._convert_direction_to_array(vehicle_direction)
        pts, mask = flatten_cones_by_type(cones, self.cfg.shapes.n_cones)
        dev = self.device
        frame = FrameInput(
            cones=torch.as_tensor(pts, device=dev)[None],
            mask=torch.as_tensor(mask, device=dev)[None],
            position=torch.as_tensor(np.asarray(vehicle_position, np.float32), device=dev)[None],
            direction=torch.as_tensor(np.asarray(vehicle_direction, np.float32), device=dev)[None],
        )
        out, self._state = planner_step(self.cfg, self._state, frame)
        return out.path[0].cpu().numpy().astype(np.float64)
