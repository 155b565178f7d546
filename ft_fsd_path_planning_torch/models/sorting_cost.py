"""Config cost function — all 7 terms of the reference, vectorized over a pool.

Counterpart of `ft_fsd_path_planning_tpu/models/sorting_cost.py` (reference
`sorting_cones/trace_sorter/cost_function.py:23-305`,
`cone_distance_cost.py:14-32`, `nearby_cone_search.py:40-367`). Configs are
(B, C, L) int index tensors padded with -1; `valid` marks live pool slots;
points are the flattened (B, N, 3) cone tensor of each frame. ``cone_type``
is a (B,) tensor, so both sides of a frame batch run as one call.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ft_fsd_path_planning_torch.config import SortingConfig
from ft_fsd_path_planning_torch.ops import gatherless as gl
from ft_fsd_path_planning_torch.ops import geometry as geo
from ft_fsd_path_planning_torch.utils.cone_types import ConeTypes

Tensor = torch.Tensor

# cost term weights (cost_function.py:283-284), normalized in float32
_WEIGHTS_RAW = np.asarray([1000.0, 200.0, 5000.0, 1000.0, 0.0, 1000.0, 1000.0], np.float32)
WEIGHTS = _WEIGHTS_RAW / _WEIGHTS_RAW.sum()


def left_sign(cone_type: Tensor) -> Tensor:
    """+1 for LEFT, -1 for RIGHT."""
    return torch.where(cone_type == ConeTypes.LEFT, 1.0, -1.0).to(torch.float32)


def config_points(points_xy: Tensor, configs: Tensor) -> Tensor:
    """(B, C, L, 2) config positions; padded (-1) slots become zero rows."""
    b, c, l = configs.shape
    return gl.take_rows(points_xy, configs.reshape(b, c * l)).reshape(b, c, l, 2)


def angle_cost(pts: Tensor, configs: Tensor) -> Tensor:
    """Normalized inverted cone-to-cone angles x (1 + #angles under 40 deg)."""
    to_next = pts[:, :, :-1, :] - pts[:, :, 1:, :]
    overwrite = (configs == -1)[:, :, 1:]
    to_next = torch.where(overwrite[..., None], torch.full_like(to_next, 100.0), to_next)

    mid_to_next = to_next[:, :, 1:, :]
    mid_to_prev = -to_next[:, :, :-1, :]
    angles = geo.vec_angle_between(mid_to_next, mid_to_prev)  # (B, C, L-2)

    is_part = (configs != -1)[:, :, 2:]
    cost_raw = (math.pi - angles) / math.pi * is_part
    under = (angles < geo.deg2rad(40.0)) & is_part
    factors = torch.sum(under, dim=-1) + 1
    denom = torch.clamp(torch.sum(is_part, dim=-1), min=1)
    return torch.sum(cost_raw, dim=-1) / denom * factors


def residual_distance_cost(pts: Tensor, configs: Tensor, threshold: float) -> Tensor:
    """Sum of segment lengths above the threshold."""
    d = geo.trace_distance_to_next(pts)
    d = d * (configs != -1)[:, :, 1:]
    return torch.sum(torch.clamp(d - threshold, min=0.0), dim=-1)


def n_cones_cost(configs: Tensor) -> Tensor:
    n = torch.clamp(torch.sum(configs != -1, dim=-1), min=1)
    return 1.0 / n


def initial_direction_cost(pts: Tensor, car_dir: Tensor) -> Tensor:
    first_seg = pts[:, :, 1, :] - pts[:, :, 0, :]
    return geo.vec_angle_between(first_seg, car_dir[:, None, :])


def _segment_angle_differences(pts: Tensor, configs: Tensor) -> tuple[Tensor, Tensor]:
    """angle_difference(angle[i], angle[i+1]) per consecutive segment pair,
    plus a per-difference validity mask."""
    d = torch.diff(pts, dim=2)
    ang = torch.atan2(d[..., 1], d[..., 0])
    diff = geo.angle_difference(ang[:, :, :-1], ang[:, :, 1:])
    return diff, (configs != -1)[:, :, 2:]


def change_of_direction_cost(pts: Tensor, configs: Tensor) -> Tensor:
    """Zero-crossing cost. Weight is 0 in the reference; kept for per-term
    parity."""
    diff, valid = _segment_angle_differences(pts, configs)
    pair_valid = valid[:, :, 1:] & valid[:, :, :-1]
    crossing = (torch.sign(diff[:, :, :-1]) != torch.sign(diff[:, :, 1:])) & pair_valid
    raw = torch.abs(diff[:, :, :-1] - diff[:, :, 1:])
    out = torch.sum(raw * crossing, dim=-1)
    n = torch.sum(configs != -1, dim=-1)
    return torch.where(n <= 3, torch.zeros_like(out), out)


def wrong_direction_cost(pts: Tensor, configs: Tensor, cone_type: Tensor) -> Tensor:
    """|sum of over-threshold wrong-direction angle changes|."""
    diff, valid = _segment_angle_differences(pts, configs)
    unwanted_sign = left_sign(cone_type)[:, None, None]
    mask = (torch.sign(diff) == unwanted_sign) & (torch.abs(diff) > geo.deg2rad(40.0)) & valid
    total = torch.sum(torch.where(mask, diff, torch.zeros_like(diff)), dim=-1)
    n = torch.sum(configs != -1, dim=-1)
    return torch.where(n <= 3, torch.zeros_like(total), torch.abs(total))


def _config_search_directions(pts: Tensor, configs: Tensor, cone_type: Tensor) -> Tensor:
    """Search direction at each config position: normal of the prev->next
    chord, one-sided at the ends. Returns (B, C, L, 2); padded positions
    carry garbage that every consumer masks."""
    l = configs.shape[2]
    lengths = torch.sum(configs != -1, dim=-1)
    pos = torch.arange(l, device=pts.device)

    prev = torch.cat([pts[:, :, :1], pts[:, :, :-1]], dim=2)
    nxt = torch.cat([pts[:, :, 1:], pts[:, :, -1:]], dim=2)
    is_first = (pos == 0)[None, None, :, None]
    is_last = (pos == lengths[..., None] - 1)[..., None]
    chord = torch.where(is_first, nxt - pts, torch.where(is_last, pts - prev, nxt - prev))
    # rotate +pi/2 (RIGHT): (x,y)->(-y,x); -pi/2 (LEFT): (x,y)->(y,-x)
    sign = torch.where(cone_type == ConeTypes.RIGHT, 1.0, -1.0).to(pts.dtype)[:, None, None]
    rotated = torch.stack([-sign * chord[..., 1], sign * chord[..., 0]], dim=-1)
    return geo.normalize_last_axis(rotated)


def cones_on_side_cost(
    points: Tensor,
    points_mask: Tensor,
    pts: Tensor,
    configs: Tensor,
    valid: Tensor,
    cone_type: Tensor,
    cfg: SortingConfig,
) -> Tensor:
    """1 / (n_good - n_bad + |min| + 1) visibility cost.

    Candidates per config: cones within the search distance of any pooled
    config cone but in no pooled config ("close"), plus cones used by other
    pooled configs ("extra"); then per position the distance gate and the
    +-60 deg angle gates around the search direction.
    """
    n = points.shape[1]
    b, c, l = configs.shape
    points_xy = points[..., :2]
    iota_n = torch.arange(n, device=points.device)

    cfg_onehot = (configs[..., None] == iota_n) & valid[:, :, None, None]  # (B, C, L, N)
    in_config = torch.any(cfg_onehot, dim=2)  # (B, C, N)
    in_any = torch.any(in_config, dim=1)  # (B, N)

    d2 = geo.cdist_sq(points_xy, points_xy)
    d2 = d2 + torch.where(torch.eye(n, dtype=torch.bool, device=points.device), 1e6, 0.0)
    within = d2 < cfg.side_search_distance**2  # (B, N, N)

    near_any = torch.any(within & (in_any & points_mask)[:, :, None], dim=1)
    close = near_any & ~in_any & points_mask  # (B, N)
    extra = in_any[:, None, :] & ~in_config  # (B, C, N)
    candidate = close[:, None, :] | extra

    dirs = _config_search_directions(pts, configs, cone_type)  # (B, C, L, 2)
    vec = points_xy[:, None, None, :, :] - pts[:, :, :, None, :]  # (B, C, L, N, 2)

    # angle(vec, +-dir) < half  <=>  +-dot(vec, dir) > cos(half)·|vec|
    half_cos = float(np.cos(np.float32(cfg.side_search_angle / 2.0)))
    vec_norm = torch.sqrt(torch.sum(vec * vec, dim=-1))
    dots = torch.sum(vec * dirs[:, :, :, None, :], dim=-1)
    good_angle = dots > half_cos * vec_norm
    bad_angle = -dots > half_cos * vec_norm

    pos_valid = (configs != -1)[..., None]
    # within[configs]: rows of padded (-1) slots are all False
    dist_gate = gl.take_rows(within, configs.reshape(b, c * l), fill=False).reshape(b, c, l, n)

    base = candidate[:, :, None, :] & dist_gate & pos_valid
    n_good = torch.sum(base & good_angle, dim=(2, 3))
    n_bad = torch.sum(base & bad_angle, dim=(2, 3))

    diff = (n_good - n_bad).to(torch.float32)
    pool_min = torch.amin(torch.where(valid, diff, torch.full_like(diff, math.inf)), dim=1)
    pool_min = torch.where(torch.isfinite(pool_min), pool_min, torch.zeros_like(pool_min))
    diff = diff + torch.abs(pool_min)[:, None] + 1.0
    return 1.0 / diff


def cost_configurations(
    points: Tensor,
    points_mask: Tensor,
    configs: Tensor,
    valid: Tensor,
    cone_type: Tensor,
    car_position: Tensor,
    car_direction: Tensor,
    cfg: SortingConfig,
    return_individual: bool = False,
) -> Tensor:
    """Total weighted cost per pooled config, (B, C); invalid slots +inf."""
    points_xy = points[..., :2]
    pts = config_points(points_xy, configs)
    terms = torch.stack(
        [
            angle_cost(pts, configs),
            residual_distance_cost(pts, configs, cfg.distance_cost_threshold),
            n_cones_cost(configs),
            initial_direction_cost(pts, car_direction),
            change_of_direction_cost(pts, configs),
            cones_on_side_cost(points, points_mask, pts, configs, valid, cone_type, cfg),
            wrong_direction_cost(pts, configs, cone_type),
        ],
        dim=-1,
    )  # (B, C, 7)
    weighted = terms * torch.as_tensor(WEIGHTS, device=terms.device)
    if return_individual:
        return weighted
    total = torch.sum(weighted, dim=-1)
    return torch.where(valid, total, torch.full_like(total, math.inf))
