"""Public NumPy-in/NumPy-out facade — the reference `PathPlanner`
(full_pipeline/full_pipeline.py:53-217) on the PyTorch planner.

Counterpart of `ft_fsd_path_planning_tpu/models/facade.py`: the facade pads
ragged host inputs into the fixed shape budget, runs one batched planner
step with a batch of one on the device, and returns the path. With
``experimental_performance_improvements`` it keeps the reference's
sorting-result cache on the host and decides per frame whether the sorter
runs at all. On the relocalizer missions (skidpad, acceleration, EBS test)
it recomputes the transform in float64 on the frame that first relocalizes.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from ft_fsd_path_planning_torch.config import PlannerConfig, default_config
from ft_fsd_path_planning_torch.device import resolve_device
from ft_fsd_path_planning_torch.models import matching, pathing, relocalization, sorting
from ft_fsd_path_planning_torch.models.planner import (
    GLOBAL_PATH_BUFFER_LEN,
    FrameInput,
    PlannerState,
    StepOutput,
    make_initial_state,
    planner_step,
    planner_step_presorted,
)
from ft_fsd_path_planning_torch.ops import beam_search
from ft_fsd_path_planning_torch.utils.cone_types import ConeTypes
from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes
from ft_fsd_path_planning_torch.utils.timer import count, span, spanned

FloatArray = np.ndarray


@dataclasses.dataclass
class RelocalizationInformation:
    """Parity with reference relocalization_information.py:12-35."""

    translation: FloatArray
    rotation: float


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


def _cone_arrays_are_similar(
    a: Optional[np.ndarray], b: Optional[np.ndarray], threshold: float
) -> bool:
    """Host-side replica of the reference's similarity test
    (core_trace_sorter.py:57-86): same shape, every cone within ``threshold``
    of its nearest counterpart, matching colors."""
    if a is None or b is None:
        return False
    if a.shape != b.shape:
        return False
    if a.shape[0] == 0:
        return True
    d = np.sum((a[:, None, :2] - b[None, :, :2]) ** 2, axis=-1)
    closest = d.min(axis=1)
    if not np.all(closest < threshold * threshold):
        return False
    if a.shape[1] == 2:
        return True
    idx = d.argmin(axis=1)
    return bool(np.all(a[:, 2] == b[idx, 2]))


def _remap_order(cached_sorted: np.ndarray, current_xy: np.ndarray) -> np.ndarray:
    """Apply a cached sorted ORDER to the current cone positions: each cached
    sorted cone is replaced by its nearest current cone (the similarity check
    guarantees a unique <0.1 m counterpart; track cones are >=1.4 m apart).
    Mirrors the reference cache-hit semantics where the cached config INDICES
    are applied to the fresh flattened cone array
    (core_trace_sorter.py:298-301 + :205-216)."""
    if len(cached_sorted) == 0:
        return cached_sorted
    d = np.sum((cached_sorted[:, None] - current_xy[None]) ** 2, axis=-1)
    return current_xy[d.argmin(axis=1)]


def _start_cones(cfg: PlannerConfig, frame: FrameInput) -> tuple[np.ndarray, np.ndarray]:
    """Per-side starting-cone selection only: the cheap program the sorting
    cache's similarity check needs before deciding to skip the full sort
    (the reference checks the starting cones first,
    core_trace_sorter.py:218-250). ``frame`` has a batch of one; returns
    (prefix (2, 2), n_first (2,)) on the host, row 0 LEFT and row 1 RIGHT."""
    mask = frame.mask
    if not cfg.sorting.use_unknown_cones:
        mask = mask & (frame.cones[..., 2] != ConeTypes.UNKNOWN)
    dev = frame.cones.device
    cone_type = torch.tensor([int(ConeTypes.LEFT), int(ConeTypes.RIGHT)], device=dev)
    two = lambda t: torch.cat([t, t], dim=0)  # noqa: E731
    prefix, n_first = sorting.select_starting_cones(
        cfg.sorting, two(frame.cones), two(mask), cone_type, two(frame.position), two(frame.direction)
    )
    both = torch.cat([prefix, n_first[:, None]], dim=1).cpu().numpy()  # one fetch
    return both[:, :2], both[:, 2]


def _fetch(tensors: tuple[torch.Tensor, ...]) -> list[np.ndarray]:
    """Bring several small device tensors to the host in ONE transfer (each
    separate ``.cpu()`` is a synchronising round trip): flattened into one
    float32 buffer (the masks and small indices are exact in it), fetched,
    and cut back into each tensor's shape and dtype."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors]).cpu().numpy()
    out, start = [], 0
    for t in tensors:
        arr = flat[start : start + t.numel()].reshape(tuple(t.shape))
        if t.dtype == torch.bool:
            arr = arr > 0.5
        elif not t.dtype.is_floating_point:
            arr = np.rint(arr).astype(np.int64)
        out.append(arr)
        start += t.numel()
    return out


class PathPlanner:
    """The reference PathPlanner, every mission.

    Runs on ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"``). Off the CPU the sorter's search runs only as kernel
    B2, matching and the path's parameterization only as their kernels, so
    a sorting config, a side length, a curvature window or a horizon that
    the kernels do not take raises ``beam_search.UnsupportedShape`` here,
    before any state is made.
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
        self.device = resolve_device(device)
        if self.device.type != "cpu":
            pathing.require_kernel_shape(self.cfg)
        if self.device.type != "cpu" and not self.cfg.has_relocalizer:
            s = self.cfg.sorting
            beam_search.require_kernel_shape(s.beam_width, s.max_length, s.max_n_neighbors)
            matching.require_kernel_shape(self.cfg.shapes.side_len)
        self._state = make_initial_state(self.cfg, 1, self.device)
        self.global_path: Optional[FloatArray] = None
        # float64 relocalization refinement bookkeeping (see _refine_reloc_f64)
        self._origin64: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._was_relocalized = False
        # sorting-result cache (experimental_performance_improvements):
        # reference ConeSortingCacheEntry, core_trace_sorter.py:100-110
        self._sort_cache: Optional[dict] = None
        self.sort_cache_hits: int = 0
        self._use_sort_cache = (
            self.cfg.experimental_performance_improvements and not self.cfg.has_relocalizer
        )

    def _convert_direction_to_array(self, direction: Any) -> FloatArray:
        direction = np.squeeze(np.array(direction, float))
        if direction.shape == (2,):
            return direction
        if direction.shape in [(1,), ()]:
            return np.array([np.cos(float(direction)), np.sin(float(direction))])
        raise ValueError("direction must be a float or a 2 element array")

    def set_global_path(self, global_path: Optional[FloatArray]) -> None:
        self.global_path = global_path
        if global_path is not None and not self.cfg.supports_global_path:
            # the common trackdrive step runs WITHOUT the global-path branch
            # (small centerline buffer); opting in switches the config. State
            # shapes are identical, so the carried state survives the switch.
            self.cfg = dataclasses.replace(self.cfg, supports_global_path=True)
        if global_path is None:
            buf = pathing.GlobalPathBuffer.empty(1, GLOBAL_PATH_BUFFER_LEN, self.device)
        else:
            gp = np.asarray(global_path, np.float32)
            n = min(len(gp), GLOBAL_PATH_BUFFER_LEN)
            pts = np.zeros((GLOBAL_PATH_BUFFER_LEN, 2), np.float32)
            pts[:n] = gp[:n]
            buf = pathing.GlobalPathBuffer(
                points=torch.as_tensor(pts, device=self.device)[None],
                n_valid=torch.tensor([n], dtype=torch.int32, device=self.device),
                active=torch.ones(1, dtype=torch.bool, device=self.device),
            )
        self._state = self._state._replace(global_path=buf)

    @spanned("stage.facade.call")
    def calculate_path_in_global_frame(
        self,
        cones: List[FloatArray],
        vehicle_position: FloatArray,
        vehicle_direction: Union[FloatArray, float],
        return_intermediate_results: bool = False,
    ) -> Union[FloatArray, Tuple[FloatArray, ...]]:
        """Run the full planning pipeline for one frame. Returns a (40, 4)
        array of (spline_parameter, x, y, curvature) waypoints; with
        ``return_intermediate_results`` the reference's 7-tuple (path,
        sorted left, sorted right, left and right with virtual cones, and
        the two match index arrays), unpadded."""
        with span("stage.facade.upload"):
            vehicle_direction = self._convert_direction_to_array(vehicle_direction)
            pts, mask = flatten_cones_by_type(cones, self.cfg.shapes.n_cones)
            dev = self.device
            frame = FrameInput(
                cones=torch.as_tensor(pts, device=dev)[None],
                mask=torch.as_tensor(mask, device=dev)[None],
                position=torch.as_tensor(np.asarray(vehicle_position, np.float32), device=dev)[None],
                direction=torch.as_tensor(np.asarray(vehicle_direction, np.float32), device=dev)[None],
            )
        if self.cfg.has_relocalizer and self._origin64 is None:
            # the reference stores the FIRST pose as the relocalization
            # origin (relocalization_base_class.py:59-68); kept at float64
            # for the refinement rerun
            self._origin64 = (
                np.array(vehicle_position, np.float64),
                np.array(vehicle_direction, np.float64),
            )

        with span("stage.facade.step"):
            if self._use_sort_cache:
                out, self._state = self._step_with_sort_cache(frame, pts, mask)
            else:
                out, self._state = planner_step(self.cfg, self._state, frame)

        # one host sync a frame until the mission has relocalized
        if (
            self.cfg.has_relocalizer
            and not self._was_relocalized
            and bool(self._state.reloc.relocalized[0])
        ):
            self._refine_reloc_f64(cones, vehicle_position, vehicle_direction)
            self._was_relocalized = True

        with span("stage.facade.fetch"):
            if not return_intermediate_results:
                return out.path[0].cpu().numpy().astype(np.float64)
            (path, sl, slm, sr, srm, lv, lm, rv, rm, l2r, r2l) = _fetch(
                (
                    out.path[0],
                    out.sorted_left[0], out.sorted_left_mask[0],
                    out.sorted_right[0], out.sorted_right_mask[0],
                    out.left_with_virtual[0], out.left_mask[0],
                    out.right_with_virtual[0], out.right_mask[0],
                    out.left_to_right[0], out.right_to_left[0],
                )
            )

        def unpad(arr, m):
            return np.asarray(arr, np.float64)[: int(np.sum(m))]

        def unpad_int(arr, m):
            return np.asarray(arr)[: int(np.sum(m))].astype(int)

        return (
            np.asarray(path, np.float64),
            unpad(sl, slm),
            unpad(sr, srm),
            unpad(lv, lm),
            unpad(rv, rm),
            unpad_int(l2r, lm),
            unpad_int(r2l, rm),
        )

    @spanned("stage.facade.refine_f64")
    def _refine_reloc_f64(
        self,
        cones: List[FloatArray],
        vehicle_position: FloatArray,
        vehicle_direction: FloatArray,
    ) -> None:
        """Recompute the SE(2) transform at float64 once relocalization
        first succeeds.

        The step's relocalizer runs in float32; its transform parameters
        differ from the reference's float64 computation by ~0.7 mm over the
        pose range, enough to flip the skidpad windowed tracker's argmin on
        knife-edge frames (gaps down to 2.5e-5 m where the multi-lap path
        overlaps itself near lap junctions). Rerunning the SAME
        relocalization code in ``torch.float64`` on the planner's own device
        with this frame's float64 inputs recovers reference-grade precision
        without a second implementation; the refined parameters, cast to
        float32, overwrite the carried state (the reference computes its
        transform in float64 once and freezes it,
        relocalization_base_class.py:70-75)."""
        pts64, mask = flatten_cones_by_type(cones, self.cfg.shapes.n_cones, dtype=np.float64)
        dev = self.device

        def f64(a) -> torch.Tensor:
            return torch.as_tensor(np.asarray(a, np.float64), device=dev)[None]

        origin_pos, origin_dir = self._origin64
        xy, m, pos = f64(pts64[:, :2]), torch.as_tensor(mask, device=dev)[None], f64(vehicle_position)
        if self.cfg.mission.name == "skidpad":
            ok, rot, trans, center = relocalization.skidpad_relocalize_once(
                xy, m, pos, f64(origin_pos), f64(origin_dir)
            )
        else:
            ok, rot, trans, center = relocalization.acceleration_relocalize_once(
                xy, m, pos, f64(vehicle_direction), f64(origin_pos)
            )
        if not bool(ok[0]):
            return  # gate knife edge: keep the step's transform
        reloc = self._state.reloc._replace(
            rotation=rot.to(torch.float32),
            translation=trans.to(torch.float32),
            center=center.to(torch.float32),
        )
        self._state = self._state._replace(reloc=reloc)

    def _step_with_sort_cache(
        self, frame: FrameInput, pts: np.ndarray, mask: np.ndarray
    ) -> tuple[StepOutput, PlannerState]:
        """Reference sorting-result cache (core_trace_sorter.py:189-250,
        298-301) at the facade boundary: if the per-side starting cones AND
        the full flattened cone set each sit within 0.1 m (positions and
        colors) of the previous frame's, skip the beam-search sorter and
        run the step with the cached sorted order applied to the CURRENT
        cone positions. Unlike the reference's per-side cache this reuses
        only when BOTH sides hit (the step runs both sides as one search).
        The lookup, up to the upload of the cached order on a hit, is the
        span `stage.facade.sort_cache`; the counters `facade.sort_cache.lookups`
        and `facade.sort_cache.hits` count the calls and the hits."""
        threshold = 0.1
        count("facade.sort_cache.lookups")
        with span("stage.facade.sort_cache"):
            if not self.cfg.sorting.use_unknown_cones:
                mask = mask & (pts[:, 2] != ConeTypes.UNKNOWN)
            flat = pts[mask]

            prefix, n_first = _start_cones(self.cfg, frame)

            def start_rows(side: int) -> np.ndarray:
                idx = prefix[side, : int(n_first[side])]
                return pts[idx] if len(idx) else np.zeros((0, 3), np.float32)

            start_l, start_r = start_rows(0), start_rows(1)

            c = self._sort_cache
            hit = (
                c is not None
                and _cone_arrays_are_similar(start_l, c["start_l"], threshold)
                and _cone_arrays_are_similar(start_r, c["start_r"], threshold)
                and _cone_arrays_are_similar(flat, c["flat"], threshold)
            )
            entry = {"flat": flat, "start_l": start_l, "start_r": start_r}
            if hit:
                self.sort_cache_hits += 1
                count("facade.sort_cache.hits")
                xy = flat[:, :2]
                sl = np.array(c["sorted_l"])
                sr = np.array(c["sorted_r"])
                lm, rm = c["sorted_l_mask"], c["sorted_r_mask"]
                sl[lm] = _remap_order(sl[lm], xy)
                sr[rm] = _remap_order(sr[rm], xy)
                # refresh the cache with THIS frame (keeping the cached sorted
                # order applied to current positions): the reference rebuilds
                # its ConeSortingCacheEntry from the fresh flattened cones every
                # call (core_trace_sorter.py:189-196), so similarity is always
                # frame-to-frame. Without this, slow cumulative SLAM drift
                # (> 0.1 m total over a stable stretch) would force re-sorts
                # the reference skips.
                self._sort_cache = dict(
                    entry,
                    sorted_l=sl.astype(np.float32), sorted_l_mask=lm,
                    sorted_r=sr.astype(np.float32), sorted_r_mask=rm,
                )
                dev = self.device
                presorted = (
                    torch.as_tensor(self._sort_cache["sorted_l"], device=dev)[None],
                    torch.as_tensor(lm, device=dev)[None],
                    torch.as_tensor(self._sort_cache["sorted_r"], device=dev)[None],
                    torch.as_tensor(rm, device=dev)[None],
                )
        if hit:
            return planner_step_presorted(self.cfg, self._state, frame, *presorted)

        out, state = planner_step(self.cfg, self._state, frame)
        sl, lm, sr, rm = _fetch(
            (out.sorted_left[0], out.sorted_left_mask[0], out.sorted_right[0], out.sorted_right_mask[0])
        )
        self._sort_cache = dict(entry, sorted_l=sl, sorted_l_mask=lm, sorted_r=sr, sorted_r_mask=rm)
        return out, state

    @property
    def relocalization_info(self) -> Optional[RelocalizationInformation]:
        reloc = self._state.reloc
        if not self.cfg.has_relocalizer or not bool(reloc.relocalized[0]):
            return None
        probes = torch.tensor([[[0.0, 0.0], [1.0, 0.0]]], device=self.device)
        known, _ = relocalization.transform_to_known_frame(reloc, probes, torch.zeros_like(probes[..., 0]))
        origin, one_zero = known[0].cpu().numpy().astype(np.float64)
        rotation = float(np.arctan2(one_zero[1] - origin[1], one_zero[0] - origin[0]))
        return RelocalizationInformation(translation=origin, rotation=rotation)
