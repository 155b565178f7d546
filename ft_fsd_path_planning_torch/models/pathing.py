"""Path calculation stage — centerline fit, MPC post-chain, parameterization.

Counterpart of `ft_fsd_path_planning_tpu/models/pathing.py` (reference
`calculate_path/core_calculate_path.py:63-575` and
`path_parameterization.py:111-328`) and the skidpad override
(`calculate_path/skidpad_calculate_path.py:21-71`): the centerline comes
from matched cone pairs, the previous path or, with
``supports_global_path``, a window of the global path rolled to the car.
Every ragged array becomes a fixed buffer plus a valid count, and the
reference's fallback lattice becomes selects on ok-flags. Tensors carry a
leading batch axis B, and every select is per lane.

The parameterization's tail after its refit (sampling, curvature, filter,
horizon) chooses from the device alone (:func:`parameterize_tail`): on the
CPU the plain PyTorch version (:func:`parameterize_tail_plain`), on the card
the hand-written kernel ``csrc/path_parameterize.cu``, one launch a call
(:func:`parameterize_tail_cuda`), which raises at a shape it does not take;
a planner for the card raises already when it is made
(:func:`require_kernel_shape`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ft_fsd_path_planning_torch.config import PlannerConfig
from ft_fsd_path_planning_torch.ops import fitpack as fpk
from ft_fsd_path_planning_torch.ops import gatherless as gl
from ft_fsd_path_planning_torch.ops import geometry as geo
from ft_fsd_path_planning_torch.ops import kernel_build
from ft_fsd_path_planning_torch.ops import spline as sp
from ft_fsd_path_planning_torch.ops.beam_search import UnsupportedShape
from ft_fsd_path_planning_torch.ops.curvature import path_curvature, uniform_filter1d_nearest
from ft_fsd_path_planning_torch.utils import timer
from ft_fsd_path_planning_torch.utils.timer import spanned

Tensor = torch.Tensor

_CENTERLINE_SLOTS = 64  # matches/previous-path centerline buffer without the global-path branch


class PathInput(NamedTuple):
    """Stage input (reference PathCalculationInput)."""

    left_cones: Tensor  # (B, S, 2)
    left_mask: Tensor  # (B, S)
    right_cones: Tensor  # (B, S, 2)
    right_mask: Tensor  # (B, S)
    left_to_right: Tensor  # (B, S) int, -1 = no match
    right_to_left: Tensor  # (B, S)
    position: Tensor  # (B, 2)
    direction: Tensor  # (B, 2)


class GlobalPathBuffer(NamedTuple):
    """Fixed-size global path (relocalization / set_global_path)."""

    points: Tensor  # (B, G, 2)
    n_valid: Tensor  # (B,)
    active: Tensor  # (B,) bool

    @staticmethod
    def empty(batch: int, g: int, device: torch.device) -> "GlobalPathBuffer":
        return GlobalPathBuffer(
            points=torch.zeros((batch, g, 2), device=device),
            n_valid=torch.zeros(batch, dtype=torch.int32, device=device),
            active=torch.zeros(batch, dtype=torch.bool, device=device),
        )


class PathState(NamedTuple):
    """Carried planner state for this stage."""

    prev_path: Tensor  # (B, H, 4) last parameterized path
    index_along_path: Tensor  # (B,) int32, skidpad tracking state


def _almost_straight_path() -> np.ndarray:
    """Reference calculate_almost_straight_path: radius 1000 chord of angle
    pi/50, 40 points, starting at the origin pointing +x."""
    radius, maximum_angle, n = 1000.0, np.pi / 50, 40
    ang = np.linspace(0, abs(maximum_angle), n)
    points = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    points -= np.array([1.0, 0.0])
    points *= radius
    c, s = np.cos(-np.pi / 2), np.sin(-np.pi / 2)
    points = points @ np.array([[c, -s], [s, c]]).T
    points[:, 1] *= np.sign(maximum_angle)
    return points.astype(np.float32)


ALMOST_STRAIGHT_PATH = _almost_straight_path()  # (40, 2)


def _pad_rows(pts: Tensor, n: int) -> Tensor:
    """(B, h, 2) -> (B, n, 2) zero-padded."""
    out = torch.zeros((pts.shape[0], n, 2), dtype=pts.dtype, device=pts.device)
    out[:, : pts.shape[1]] = pts
    return out


def _norm(v: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _fit_and_densify(
    cfg: PlannerConfig, points: Tensor, mask: Tensor, smoothing: float,
    n_samples: int | None = None,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Spline fit + 0.1 m dense evaluation -> (dense (B, D, 2), n_valid,
    ok, budget_hit)."""
    d = n_samples if n_samples is not None else cfg.shapes.dense_samples
    fit = fpk.fitpack_fit(points, mask, smoothing)
    vals, _, valid = fpk.fitpack_eval_every(fit, cfg.path.predict_every, d)
    return vals, torch.sum(valid, dim=1), fit.ok, fit.budget_hit


def trivial_path(position: Tensor, direction: Tensor) -> tuple[Tensor, Tensor]:
    """Reference calculate_trivial_path (core_calculate_path.py:127-134):
    the almost-straight chord (minus its first point) rotated to the car
    frame. Returns ((B, 39, 2) points, (B, 39) mask)."""
    origin = torch.as_tensor(ALMOST_STRAIGHT_PATH[1:], device=position.device)
    yaw = geo.angle_from_2d_vector(direction)
    pts = geo.rotate(origin[None], yaw[:, None]) + position[:, None]
    return pts, torch.ones(pts.shape[:2], dtype=torch.bool, device=position.device)


# ---------------------------------------------------------------------------
# centerline selection
# ---------------------------------------------------------------------------


def _global_path_centerline(
    cfg: PlannerConfig, gp: GlobalPathBuffer, position: Tensor
) -> tuple[Tensor, Tensor]:
    """Roll the global path so the closest point sits at len//3, keep points
    within 30 m (core_calculate_path.py:516-529). Returns (B, CL, 2) + mask."""
    cl = cfg.shapes.global_window
    g = gp.points.shape[1]
    iota = torch.arange(g, device=position.device)[None, :]
    in_path = iota < gp.n_valid[:, None]
    dist = _norm(gp.points - position[:, None])
    idx_closest = geo.masked_argmin(dist, in_path)
    n = torch.clamp(gp.n_valid, min=1)
    # rolled[i] = original[(i + s) mod n] on the valid prefix of length n;
    # slots past it are never kept
    s = torch.remainder(idx_closest - n // 3, n)
    rolled = gl.take_rows(gp.points, torch.remainder(iota + s[:, None], n[:, None]))
    keep = in_path & (_norm(rolled - position[:, None]) < 30.0)
    order, valid = geo.stable_compact(keep, cl)
    return gl.take_rows(rolled, order), valid


def _matches_centerline(
    inp: PathInput, prev_xy: Tensor, cl: int
) -> tuple[Tensor, Tensor]:
    """Midpoints of matched cone pairs of the better side
    (select_side_to_use + calculate_centerline_points_of_matches); the
    previous path if fewer than 2 matches."""

    def side_score(matches: Tensor, mask: Tensor) -> tuple[Tensor, Tensor]:
        has = (matches != -1) & mask
        return torch.sum(has, dim=1), torch.sum(torch.where(has, matches, 0), dim=1)

    n_l, sum_l = side_score(inp.left_to_right, inp.left_mask)
    n_r, sum_r = side_score(inp.right_to_left, inp.right_mask)
    # max([LEFT, RIGHT], key=score): LEFT wins ties
    use_left = (n_l > n_r) | ((n_l == n_r) & (sum_l >= sum_r))

    ul = use_left[:, None]
    side = torch.where(ul[..., None], inp.left_cones, inp.right_cones)
    side_mask = torch.where(ul, inp.left_mask, inp.right_mask)
    matches = torch.where(ul, inp.left_to_right, inp.right_to_left)
    other = torch.where(ul[..., None], inp.right_cones, inp.left_cones)

    matched = (matches != -1) & side_mask
    partner = gl.take_rows(other, matches)  # -1 -> zero row, masked below
    centers = (side + partner) / 2.0

    order, valid = geo.stable_compact(matched, cl)
    centers_c = gl.take_rows(centers, order)

    # < 2 matched centers -> previous path points
    too_few = (torch.sum(matched, dim=1) < 2)[:, None]
    h = prev_xy.shape[1]
    prev_padded = _pad_rows(prev_xy, cl)
    prev_valid = (torch.arange(cl, device=prev_xy.device) < h)[None, :]
    compact = torch.where(valid[..., None], centers_c, torch.zeros_like(centers_c))
    pts = torch.where(too_few[..., None], prev_padded, compact)
    mask = torch.where(too_few, prev_valid, valid)
    return pts, mask


# ---------------------------------------------------------------------------
# MPC post-chain (create_path_for_mpc_from_path_update)
# ---------------------------------------------------------------------------


def _connect_path_to_car(
    path: Tensor, n_valid: Tensor, position: Tensor, direction: Tensor
) -> tuple[Tensor, Tensor]:
    """Prepend a point just in front of the car when the path starts ahead."""
    first = path[:, 0]
    car_to_first = first - position
    dist = _norm(car_to_first)
    ang = geo.vec_angle_between(car_to_first, direction)
    skip = (dist < 0.5) | (ang > math.pi / 2)

    new_point = position + geo.normalize_last_axis(car_to_first) * 0.2
    shifted = torch.roll(path, 1, dims=1)
    shifted[:, 0] = new_point
    d = path.shape[1]
    path_out = torch.where(skip[:, None, None], path, shifted)
    n_out = torch.where(skip, n_valid, torch.clamp(n_valid + 1, max=d))
    return path_out, n_out


def _linspace(start: Tensor, stop: Tensor, num: int) -> Tensor:
    """`jnp.linspace(start, stop, num)` per lane: start*(1-t) + stop*t with
    t = i/(num-1), the last sample exactly ``stop``."""
    div = num - 1
    step = torch.arange(div, dtype=start.dtype, device=start.device) / float(div)
    out = start[:, None] * (1 - step) + stop[:, None] * step
    return torch.cat([out, stop[:, None]], dim=1)


def _extend_path(
    path: Tensor, n_valid: Tensor, position: Tensor, direction: Tensor, mpc_path_length: float
) -> tuple[Tensor, Tensor]:
    """Append a circular arc (or straight ray) when the in-front path is
    shorter than the MPC horizon."""
    bsz, d, _ = path.shape
    dev = path.device
    iota = torch.arange(d, device=dev)[None, :]
    nv = n_valid[:, None]
    valid = iota < nv

    in_front_raw = torch.sum((path - position[:, None]) * direction[:, None], dim=2) > 0
    in_front = torch.cummax((in_front_raw & valid).to(torch.int32), dim=1).values > 0
    in_front = in_front | (iota >= nv - 20)
    in_front = in_front & valid

    seg_valid = in_front[:, 1:] & in_front[:, :-1]
    seg = geo.trace_distance_to_next(path)
    front_length = torch.sum(torch.where(seg_valid, seg, torch.zeros_like(seg)), dim=1)
    needs_ext = front_length <= mpc_path_length

    # last 20 valid points (negative slots zeroed and masked)
    last_idx = torch.clamp(n_valid - 1, min=0)
    rel_mask = (nv - 20 + torch.arange(20, device=dev)[None, :]) >= 0
    relevant = gl.window(path, n_valid - 20, 20)
    circ = geo.circle_fit(relevant, rel_mask)
    center, radius = circ[:, :2], circ[:, 2]
    radius_to_use = torch.clamp(radius, 10.0, 100.0)

    rel_centered = relevant - center[:, None]
    count = torch.sum(rel_mask, dim=1)
    first_off = geo.first_true(rel_mask)
    three = gl.take_rows(
        rel_centered,
        torch.clamp(
            torch.stack([first_off, first_off + count // 2, first_off + count - 1], dim=1), 0, 19
        ),
    )
    det = (three[:, 1, 0] - three[:, 0, 0]) * (three[:, 2, 1] - three[:, 0, 1]) - (
        three[:, 1, 1] - three[:, 0, 1]
    ) * (three[:, 2, 0] - three[:, 0, 0])
    orientation_sign = torch.sign(det)

    start_angle = geo.angle_from_2d_vector(three[:, 0])
    end_angle = start_angle + orientation_sign * math.pi
    arc_angles = _linspace(start_angle, end_angle, 50)
    arc_raw = geo.unit_2d_vector_from_angle(arc_angles) * radius_to_use[:, None, None]
    tail2 = gl.take_rows(path, torch.stack([last_idx, torch.clamp(n_valid - 2, min=0)], dim=1))
    last_point, second_last = tail2[:, 0], tail2[:, 1]
    arc_pts = (arc_raw - arc_raw[:, :1] + last_point[:, None])[:, 1:]  # 49 points

    ray_dir = geo.normalize_last_axis(last_point - second_last)
    steps = torch.arange(1, 30, dtype=path.dtype, device=dev)[None, :, None]
    ray_pts = last_point[:, None] + ray_dir[:, None] * steps  # 29

    use_arc = radius_to_use < 80.0
    n_ext = torch.where(use_arc, 49, 29)
    ray_full = torch.zeros_like(arc_pts)
    ray_full[:, :29] = ray_pts
    ext = torch.where(use_arc[:, None, None], arc_pts, ray_full)

    # write the extension after n_valid
    ext_full = torch.zeros_like(path)
    ext_full[:, :49] = ext
    ext_shifted = gl.shift_right(ext_full, n_valid)  # row i = ext[i - n_valid]
    can_write = (iota >= nv) & (iota < nv + n_ext[:, None]) & needs_ext[:, None]
    path_out = torch.where(can_write[..., None], ext_shifted, path)
    n_out = torch.where(needs_ext, torch.clamp(n_valid + n_ext, max=d), n_valid)
    return path_out, n_out


def _remove_path_behind_car(
    path: Tensor, n_valid: Tensor, position: Tensor
) -> tuple[Tensor, Tensor]:
    """Drop everything before the closest point to the car."""
    valid = torch.arange(path.shape[1], device=path.device)[None, :] < n_valid[:, None]
    dist = _norm(path - position[:, None])
    idx = geo.masked_argmin(dist, valid)
    return gl.shift_left(path, idx), n_valid - idx


def _trim_to_mpc_length(
    path: Tensor, n_valid: Tensor, mpc_path_length: float
) -> tuple[Tensor, Tensor, Tensor]:
    """Truncate at the first point whose cumulative distance exceeds the MPC
    length. Returns (path, n_out, ok)."""
    d = path.shape[1]
    seg_valid = torch.arange(1, d, device=path.device)[None, :] < n_valid[:, None]
    seg = geo.trace_distance_to_next(path)
    seg = torch.where(seg_valid, seg, torch.zeros_like(seg))
    cum = torch.cumsum(seg, dim=1)
    over = (cum > mpc_path_length) & seg_valid
    any_over = torch.any(over, dim=1)
    first_over = geo.first_true(over)
    n_keep = torch.where(any_over, first_over, n_valid)
    ok = n_valid > 2  # reference: len(mask) <= 1 -> previous path
    return path, torch.minimum(n_keep, n_valid), ok


# ---------------------------------------------------------------------------
# parameterization
# ---------------------------------------------------------------------------


class ParamTail(NamedTuple):
    """The parameterization tail's results."""

    out: Tensor  # (B, H, 4) [u, x, y, filtered curvature] at the horizon's samples
    ok: Tensor  # (B,) bool: at least H samples and the refit ok
    n_pts: Tensor  # (B,) int64 samples within the refit spline
    indices: Tensor  # (B, H) int32 the horizon's sample indices


def parameterize_tail_plain(
    cfg: PlannerConfig, fit: fpk.FpSpline, predict_every: Tensor, p_eval: int
) -> ParamTail:
    """Sample the refit spline every ``predict_every`` (B,) into ``p_eval``
    slots, take the windowed circle-fit curvature and its box filter, and
    pick the MPC horizon's rows."""
    horizon = cfg.path.mpc_prediction_horizon
    dev = predict_every.device
    pts, u_grid, pts_valid = fpk.fitpack_eval_every(fit, predict_every, p_eval)
    n_pts = torch.sum(pts_valid, dim=1)

    window = torch.clamp(n_pts // 5, max=30)
    window = window + (window % 2 == 0).to(window.dtype)
    curv = path_curvature(
        pts,
        n_pts,
        window,
        cfg.shapes.curvature_window,
        cfg.path.curvature_radius_min,
        cfg.path.curvature_radius_max,
    )
    filt_size = torch.clamp(window // 2, min=2)
    curv_f = uniform_filter1d_nearest(curv, n_pts, filt_size, cfg.shapes.curvature_window)

    # linspace(0, n-1, horizon) int truncation (path_parameterization.py:277-282)
    lin = torch.arange(horizon, dtype=torch.float32, device=dev)[None, :] * (
        torch.clamp(n_pts - 1, min=0).to(torch.float32)[:, None] / (horizon - 1)
    )
    indices = torch.clamp(lin.to(torch.int32), 0, p_eval - 1)
    ok = (n_pts >= horizon) & fit.ok  # duplicates -> ValueError -> fallback

    pts_h = gl.take_rows(pts, indices)  # (B, H, 2)
    out = torch.stack(
        [
            gl.take_vec(u_grid, indices),
            pts_h[..., 0],
            pts_h[..., 1],
            gl.take_vec(curv_f, indices),
        ],
        dim=2,
    )
    return ParamTail(out=out, ok=ok, n_pts=n_pts, indices=indices)


#: the most samples, the widest curvature window the kernel takes
KERNEL_MAX_SAMPLES, KERNEL_MAX_WINDOW = 256, 63
#: ops/geometry.py::circle_fit's Newton trips, as path_curvature calls it
_CIRCLE_FIT_MAX_ITER = 32
#: launches of the CUDA kernel since the last reset (plain calls do not count)
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def tail_samples(cfg: PlannerConfig) -> int:
    """The sample slots of the tail (``p_eval``) for the planner's dense
    buffer: the refit eval emits <= horizon*3 + 1 samples, so 192 slots
    cover it."""
    return min(192, cfg.shapes.dense_samples)


def kernel_supports(p: int, w: int, h: int) -> bool:
    """Whether the CUDA kernel takes p sample slots, a curvature window of w
    and a horizon of h rows."""
    return 1 <= p <= KERNEL_MAX_SAMPLES and 1 <= w <= KERNEL_MAX_WINDOW and w % 2 == 1 and 2 <= h <= p


def require_kernel_shape(cfg: PlannerConfig, p: int | None = None) -> None:
    """Raise :class:`UnsupportedShape` unless the kernel takes the tail's
    shape under ``cfg`` (at ``p`` sample slots, default the planner's)."""
    p = tail_samples(cfg) if p is None else p
    w, h = cfg.shapes.curvature_window, cfg.path.mpc_prediction_horizon
    if not kernel_supports(p, w, h):
        raise UnsupportedShape(
            f"the parameterization kernel does not take p_eval {p}, curvature_window {w}, "
            f"mpc_prediction_horizon {h}: 1 <= p_eval <= {KERNEL_MAX_SAMPLES}, an odd window "
            f"<= {KERNEL_MAX_WINDOW}, 2 <= horizon <= p_eval"
        )


def param_kernel_bytes(b: int, h: int) -> int:
    """Bytes the kernel must move: a fit (24 knots and their count, 28 x 2
    coefficients, the chord length, ok) and predict_every in; H rows of four
    floats, ok, the count and H indices out."""
    return b * ((fpk.MAX_INT + 2 * fpk.NC + 2) * 4 + 4 + 1 + h * 16 + 1 + 8 + h * 4)


def param_kernel_flops(b: int, p: int, w: int, h: int) -> int:
    """Operations the kernel needs, counted from its arithmetic: a sample's
    span, basis and sum (~60), the mean and six moments over its window's w
    slots (~27 a slot), 32 Newton trips of ~15 at most and the circle's
    centre (~30); a row's filter over its slots (~2 a slot)."""
    return b * (p * (60 + 27 * w + 32 * 15 + 30) + h * 2 * w)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernel_build.load("path_parameterize")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.parameterize_tail_f32.argtypes = [ptr] * 6 + [i32] * 5 + [f32] * 3 + [ptr] * 5
    lib.parameterize_tail_f32.restype = ctypes.c_int
    return lib


def parameterize_tail_cuda(
    cfg: PlannerConfig, fit: fpk.FpSpline, predict_every: Tensor, p_eval: int
) -> ParamTail:
    """Launch the CUDA kernel on the current stream (no synchronisation): one
    block a lane, one thread a sample, the whole tail in one launch. The
    same arguments and results as :func:`parameterize_tail_plain`; raises on
    what the kernel does not take before it launches."""
    global launch_count
    require_kernel_shape(cfg, p_eval)
    b = predict_every.shape[0]
    f32 = {"t_int": (fit.t_int, (b, fpk.MAX_INT)), "coef": (fit.coef, (b, fpk.NC, 2)),
           "u_max": (fit.u_max, (b,)), "predict_every": (predict_every, (b,))}
    typed = dict(f32, n_int=(fit.n_int, (b,)), ok=(fit.ok, (b,)))
    for name, (tensor, shape) in typed.items():
        if tuple(tensor.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(tensor.shape)}")
        want = torch.float32 if name in f32 else torch.int32 if name == "n_int" else torch.bool
        if tensor.dtype != want:
            raise TypeError(f"{name} must be {want}, got {tensor.dtype}")
    dev = predict_every.device
    if any(t.device.type != "cuda" or t.device != dev for t, _ in typed.values()):
        raise ValueError("parameterize_tail_cuda takes CUDA tensors on one device")
    h = cfg.path.mpc_prediction_horizon
    out = ParamTail(
        out=torch.empty((b, h, 4), dtype=torch.float32, device=dev),
        ok=torch.empty((b,), dtype=torch.bool, device=dev),
        n_pts=torch.empty((b,), dtype=torch.int64, device=dev),
        indices=torch.empty((b, h), dtype=torch.int32, device=dev),
    )
    if b == 0:
        return out
    args = [t.contiguous() for t in (fit.t_int, fit.n_int, fit.coef, fit.u_max, fit.ok, predict_every)]
    inv_h1 = float(np.float32(1.0) / np.float32(h - 1))  # a division by a Python int on the card
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.parameterize_tail_f32(
            *(t.data_ptr() for t in args), b, p_eval, cfg.shapes.curvature_window, h, _CIRCLE_FIT_MAX_ITER,
            cfg.path.curvature_radius_min, cfg.path.curvature_radius_max, inv_h1,
            *(t.data_ptr() for t in out), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"parameterize_tail kernel launch failed: CUDA error {err}")
    launch_count += 1
    timer.count("pathing.param_kernel.launches")  # one a launch, no sync
    return out


@spanned("stage.pathing.param_tail")
def parameterize_tail(
    cfg: PlannerConfig, fit: fpk.FpSpline, predict_every: Tensor, p_eval: int
) -> ParamTail:
    """The parameterization tail: the plain version for CPU tensors, the
    kernel for any other, which raises at a shape it does not take."""
    if predict_every.device.type == "cpu":
        return parameterize_tail_plain(cfg, fit, predict_every, p_eval)
    return parameterize_tail_cuda(cfg, fit, predict_every, p_eval)


def _parameterize_path(
    cfg: PlannerConfig, path: Tensor, n_valid: Tensor
) -> tuple[Tensor, Tensor, Tensor]:
    """Refit with light smoothing, curvature via windowed circle fit, sample
    the MPC horizon -> ((B, H, 4) [theta, x, y, curvature], ok, budget_hit)."""
    d = path.shape[1]
    dev = path.device
    horizon = cfg.path.mpc_prediction_horizon

    seg_valid = torch.arange(1, d, device=dev)[None, :] < n_valid[:, None]
    seg = geo.trace_distance_to_next(path)
    seg = torch.where(seg_valid, seg, torch.zeros_like(seg))
    path_length = torch.sum(seg, dim=1)
    first10 = torch.clamp(torch.clamp(torch.sum(seg_valid, dim=1), min=1), max=10)
    head = torch.arange(d - 1, device=dev)[None, :] < first10[:, None]
    mean_point_distance = torch.sum(torch.where(head, seg, torch.zeros_like(seg)), dim=1) / first10

    predict_every = path_length / horizon / 3.0
    skip_f = predict_every / torch.clamp(mean_point_distance, min=1e-9)
    skip = torch.clamp(
        torch.where(torch.isfinite(skip_f), fpk._f32_to_i32(skip_f), torch.ones_like(first10, dtype=torch.int32)),
        min=1,
    )

    # path[::skip]: the post-trim input has <= ~211 valid points, so the
    # strided table fits 256 slots; the refit eval emits <= horizon*3 + 1
    # samples, so 192 slots cover it
    p_fit = min(256, d)
    p_eval = min(192, d)
    take = torch.arange(p_fit, device=dev)[None, :] * skip[:, None]
    skipped_valid = take < n_valid[:, None]
    skipped = gl.take_rows(path, take)

    fit = fpk.fitpack_fit(skipped, skipped_valid, cfg.path.refit_smoothing)
    tail = parameterize_tail(cfg, fit, predict_every, p_eval)
    return tail.out, tail.ok, fit.budget_hit


def parameterize_trace(cfg: PlannerConfig, points: Tensor, mask: Tensor) -> Tensor:
    """Parameterize arbitrary masked traces points (B, n, 2) (the initial
    path, reference core_calculate_path.py:103-121). At most 256 input
    points: the refit's strided sample table holds 256 slots."""
    d = cfg.shapes.dense_samples
    n = points.shape[1]
    if n > 256:
        raise ValueError(
            f"parameterize_trace supports at most 256 input points (got {n}): "
            "the refit's strided sample table holds 256 slots and skip can "
            "be 1 for densely spaced traces; downsample the trace first"
        )
    buf = _pad_rows(points, d)
    out, _, _ = _parameterize_path(cfg, buf, torch.sum(mask, dim=1))
    return out


# ---------------------------------------------------------------------------
# stage entry
# ---------------------------------------------------------------------------


class PathOutput(NamedTuple):
    path: Tensor  # (B, H, 4)
    centerline: Tensor  # (B, CL, 2) aux: center_along_match_connection
    centerline_mask: Tensor  # (B, CL)
    state: PathState
    ok: Tensor  # (B,) False = this frame fell back to the previous path
    too_far: Tensor  # (B,) path overwritten for being > max dist from car
    spline_budget_hit: Tensor  # (B,) a FITPACK fit exited on its knot budget


@spanned("stage.pathing.run")
def run_path_calculation(
    cfg: PlannerConfig,
    inp: PathInput,
    gp: GlobalPathBuffer,
    state: PathState,
) -> PathOutput:
    """Full stage (reference run_path_calculation, core_calculate_path.py:514-575)."""
    d = cfg.shapes.dense_samples
    dev = inp.position.device
    prev_xy = state.prev_path[:, :, 1:3]
    h = prev_xy.shape[1]

    # ---- centerline selection. Without global-path support the centerline
    # is matches midpoints or the 40-point previous path: a 64-slot buffer
    # instead of the global_window-sized one (the fit cost scales with it)
    n_l = torch.sum(inp.left_mask, dim=1)
    n_r = torch.sum(inp.right_mask, dim=1)
    use_gp = cfg.supports_global_path
    cl = cfg.shapes.global_window if use_gp else _CENTERLINE_SLOTS
    match_pts, match_mask = _matches_centerline(inp, prev_xy, cl)

    prev_padded = _pad_rows(prev_xy, cl)
    prev_mask = (torch.arange(cl, device=dev) < h)[None, :].expand(prev_xy.shape[0], -1)

    too_few_cones = ((n_l < 3) & (n_r < 3))[:, None]
    camc_pts = torch.where(too_few_cones[..., None], prev_padded, match_pts)
    camc_mask = torch.where(too_few_cones, prev_mask, match_mask)
    if use_gp:
        gp_active = gp.active[:, None]
        global_pts, global_mask = _global_path_centerline(cfg, gp, inp.position)
        camc_pts = torch.where(gp_active[..., None], global_pts, camc_pts)
        camc_mask = torch.where(gp_active, global_mask, camc_mask)
    camc_pts = torch.where(camc_mask[..., None], camc_pts, torch.zeros_like(camc_pts))

    # ---- fit + densify (fit_matches_as_spline, with the skidpad override)
    new_index_along_path = state.index_along_path
    if cfg.mission.name == "skidpad":
        dense, n_dense, new_index_along_path = _skidpad_path_update(
            cfg, gp, state, inp.position, inp.direction
        )
        cl_budget = torch.zeros_like(too_few_cones[:, 0])
    else:
        # splprep failure -> fit the previous path instead; the failure
        # condition is known from the chord parameterization, so the
        # fallback is an input select rather than a second fit
        _, _, camc_fit_ok = sp.chord_lengths(camc_pts, camc_mask)
        fit_ok = camc_fit_ok[:, None]
        fit_pts = torch.where(fit_ok[..., None], camc_pts, prev_padded)
        fit_mask = torch.where(fit_ok, camc_mask, prev_mask)
        dense, n_dense, _, cl_budget = _fit_and_densify(cfg, fit_pts, fit_mask, cfg.path.smoothing)

    # ---- overwrite if too far from the car -> raw previous points
    dense_valid = torch.arange(d, device=dev)[None, :] < n_dense[:, None]
    dist = _norm(dense - inp.position[:, None])
    min_dist = torch.amin(torch.where(dense_valid, dist, torch.full_like(dist, math.inf)), dim=1)
    too_far = min_dist > cfg.path.maximal_distance_for_valid_path
    dense = torch.where(too_far[:, None, None], _pad_rows(prev_xy, d), dense)
    n_dense = torch.where(too_far, torch.full_like(n_dense, h), n_dense)

    # ---- MPC chain. Early behind-car trim on an active global path ONLY:
    # that branch can fill the whole dense buffer (the car sits at 1/3 of a
    # 60 m window), leaving no room for the connect and extend steps; there
    # the trim keeps the semantics because the car is ON the path. In the
    # matches and fallback branches the reference trims only AFTER
    # connect_path_to_car.
    if use_gp:
        dense_t, n_dense_t = _remove_path_behind_car(dense, n_dense, inp.position)
        dense = torch.where(gp.active[:, None, None], dense_t, dense)
        n_dense = torch.where(gp.active, n_dense_t, n_dense)

    p1, n1 = _connect_path_to_car(dense, n_dense, inp.position, inp.direction)
    p2, n2 = _extend_path(p1, n1, inp.position, inp.direction, cfg.path.mpc_path_length)
    p3, n3 = _remove_path_behind_car(p2, n2, inp.position)

    refit = fpk.fitpack_fit(
        p3, torch.arange(d, device=dev)[None, :] < n3[:, None], cfg.path.smoothing
    )
    p4, _, v4 = fpk.fitpack_eval_every(
        refit, cfg.path.predict_every, d, max_u=cfg.path.mpc_path_length * 1.5
    )
    n4 = torch.sum(v4, dim=1)

    p5, n5, trim_ok = _trim_to_mpc_length(p4, n4, cfg.path.mpc_path_length)
    out, param_ok, param_budget = _parameterize_path(cfg, p5, n5)

    ok = refit.ok & trim_ok & param_ok
    final = torch.where(ok[:, None, None], out, state.prev_path)

    new_state = PathState(prev_path=final, index_along_path=new_index_along_path)
    return PathOutput(
        path=final, centerline=camc_pts, centerline_mask=camc_mask, state=new_state,
        ok=ok, too_far=too_far,
        spline_budget_hit=cl_budget | refit.budget_hit | param_budget,
    )


def _skidpad_path_update(
    cfg: PlannerConfig,
    gp: GlobalPathBuffer,
    state: PathState,
    position: Tensor,
    direction: Tensor,
) -> tuple[Tensor, Tensor, Tensor]:
    """Skidpad override of fit_matches_as_spline
    (skidpad_calculate_path.py:49-71): windowed nearest-point tracking along
    the fixed global path; before relocalization the trivial path.

    Returns (dense (B, D, 2), n_valid (B,), new_index_along_path (B,)).
    """
    d = cfg.shapes.dense_samples
    dev = position.device
    g = gp.points.shape[1]

    seg = geo.trace_distance_to_next(gp.points[:, :10])
    mean_distance = torch.clamp(torch.sum(seg, dim=1) / seg.shape[1], min=1e-6)
    max_change = fpk._f32_to_i32(20.0 / mean_distance)

    index = state.index_along_path
    min_index = torch.clamp(index - max_change, min=0)
    max_index = torch.minimum(index + max_change, gp.n_valid)

    iota = torch.arange(g, device=dev)[None, :]
    in_window = (iota >= min_index[:, None]) & (iota < max_index[:, None])
    index_to_use = geo.masked_argmin(_norm(gp.points - position[:, None]), in_window).to(torch.int32)
    final_index = index_to_use + fpk._f32_to_i32(25.0 / mean_distance)

    take = index_to_use[:, None] + torch.arange(d, device=dev)[None, :]
    track_valid = (take < final_index[:, None]) & (take < gp.n_valid[:, None])
    tracked = gl.window(gp.points, index_to_use, d)

    # before relocalization: the trivial straight path from the car (:54-55)
    triv, _ = trivial_path(position, direction)
    active = gp.active[:, None]
    dense = torch.where(
        active[..., None],
        torch.where(track_valid[..., None], tracked, torch.zeros_like(tracked)),
        _pad_rows(triv, d),
    )
    n_dense = torch.where(gp.active, torch.sum(track_valid, dim=1), triv.shape[1])
    new_index = torch.where(gp.active, index_to_use, index)
    return dense, n_dense, new_index


def initial_path_state(cfg: PlannerConfig, batch: int, device: torch.device) -> PathState:
    """Reference CalculatePath.__init__: the previous path seeded with the
    spline-fitted almost-straight chord, parameterized. Computed once and
    repeated over the batch."""
    base = torch.as_tensor(ALMOST_STRAIGHT_PATH, device=device)[None]
    cl = cfg.shapes.global_window
    pts = _pad_rows(base, cl)
    mask = (torch.arange(cl, device=device) < base.shape[1])[None, :]
    # the almost-straight chord is ~63 m long: a larger one-off dense budget
    # makes the initial path span the same length as the reference
    dense, n_dense, _, _ = _fit_and_densify(cfg, pts, mask, cfg.path.smoothing, n_samples=768)
    out, _, _ = _parameterize_path(cfg, dense, n_dense)
    return PathState(
        prev_path=out.expand(batch, -1, -1).contiguous(),
        index_along_path=torch.zeros(batch, dtype=torch.int32, device=device),
    )
