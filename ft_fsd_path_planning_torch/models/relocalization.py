"""Relocalization — batched SE(2) transform estimation for skidpad/accel.

Counterpart of `ft_fsd_path_planning_tpu/models/relocalization.py` (reference
`relocalization/relocalization_base_class.py`,
`skidpad/skidpad_relocalizer.py`,
`acceleration/acceleration_relocalization.py`):

* the transform closures are an explicit SE(2) parameterization carried in
  :class:`RelocState`:   forward:  p' = R(rot) (p + t - c) + c,  yaw' = yaw+rot
                         inverse:  p  = R(-rot)(p' - c) + c - t, yaw' = yaw-rot
* the skidpad powerset circle fits are one masked circle fit over a static
  table of the C(20,3) index trios;
* DBSCAN clustering is connected components by path doubling over the
  (compacted) accepted centers, then masked medians and an 18.25 m pair
  search;
* the acceleration RANSAC line fit uses a static random-subset table
  instead of np.random state.

Every function takes a leading batch axis B of independent frames and is
generic in dtype: the planner step runs it in float32, the facade's
refinement in float64 on the same device. Constants are cast at the use
site, as in the JAX package.
"""

from __future__ import annotations

import functools
import math
from itertools import combinations
from typing import NamedTuple

import numpy as np
import torch

from ft_fsd_path_planning_torch.assets.known_paths import BASE_SKIDPAD_PATH
from ft_fsd_path_planning_torch.config import PlannerConfig
from ft_fsd_path_planning_torch.ops import gatherless as gl
from ft_fsd_path_planning_torch.ops import geometry as geo
from ft_fsd_path_planning_torch.utils.timer import spanned

Tensor = torch.Tensor

_N_CLOSEST = 20
_MAX_CENTERS = 64
_CIRCLE_RADIUS = 7.625  # cone circle radius gate (skidpad_relocalizer.py:59)
_NN_DIST = 2.4
_RESIDUAL_MAX = 0.4
_CENTER_SEP = 18.25
_DBSCAN_EPS = 3.0


class RelocState(NamedTuple):
    has_origin: Tensor  # (B,) bool — original pose stored
    origin_position: Tensor  # (B, 2)
    origin_direction: Tensor  # (B, 2)
    relocalized: Tensor  # (B,) bool
    rotation: Tensor  # (B,)
    translation: Tensor  # (B, 2)
    center: Tensor  # (B, 2)

    @staticmethod
    def initial(batch: int, device: torch.device) -> "RelocState":
        def zeros(*shape, dtype=torch.float32):
            return torch.zeros((batch,) + shape, dtype=dtype, device=device)

        return RelocState(
            has_origin=zeros(dtype=torch.bool),
            origin_position=zeros(2),
            origin_direction=zeros(2),
            relocalized=zeros(dtype=torch.bool),
            rotation=zeros(),
            translation=zeros(2),
            center=zeros(2),
        )


def _per_lane(v: Tensor, like: Tensor) -> Tensor:
    """(B, ...) per-lane value with singleton axes inserted after the batch
    axis so that it broadcasts against ``like`` (B, ..., 2) points or
    (B, ...) angles."""
    extra = like.dim() - v.dim()
    return v.reshape(v.shape[:1] + (1,) * extra + v.shape[1:])


def transform_to_known_frame(state: RelocState, pos: Tensor, yaw: Tensor) -> tuple[Tensor, Tensor]:
    """pos (B, 2) or (B, P, 2), yaw (B,) or (B, P)."""
    t, c = _per_lane(state.translation, pos), _per_lane(state.center, pos)
    p = geo.rotate(pos + t - c, _per_lane(state.rotation, pos[..., 0])) + c
    return p, yaw + _per_lane(state.rotation, yaw)


def transform_to_original_frame(state: RelocState, pos: Tensor, yaw: Tensor) -> tuple[Tensor, Tensor]:
    t, c = _per_lane(state.translation, pos), _per_lane(state.center, pos)
    p = geo.rotate(pos - c, -_per_lane(state.rotation, pos[..., 0])) + c - t
    return p, yaw - _per_lane(state.rotation, yaw)


# ---------------------------------------------------------------------------
# skidpad
# ---------------------------------------------------------------------------


@functools.cache
def _subset_table() -> np.ndarray:
    """All C(20,3) index subsets in lexicographic order, (1140, 3).

    The reference intends sizes 3..5 but shadows its iterable
    (`for idxs in combinations(idxs, i)`, skidpad_relocalizer.py:36-41):
    after the size-3 pass ``idxs`` is the last 3-tuple, so the size-4/5
    passes iterate an empty ``combinations`` and only trios are ever fit.
    Matching that exactly matters: at the relocalization frame only ~7
    circles are accepted, so every extra accepted center shifts the cluster
    medians at decimeter scale.
    """
    return np.asarray(list(combinations(range(_N_CLOSEST), 3)), np.int32)


@functools.cache
def _noise_tables() -> np.ndarray:
    """Per-``n_close`` noise tables (21, 1140, 3, 2) replaying the
    reference's RandomState(42) stream exactly (skidpad_relocalizer.py:38-53:
    one fresh randn(size,2) draw per *evaluated* trio, in
    combinations(range(n),3) order, so the value a trio receives depends on
    how many close cones exist). Exactness matters: the 1e-3 jitter is
    amplified ~50x by the 3-point circle fit's conditioning into 2-5 cm
    center shifts."""
    index_of = {t: i for i, t in enumerate(combinations(range(_N_CLOSEST), 3))}
    tables = np.zeros((_N_CLOSEST + 1, len(index_of), 3, 2), np.float32)
    for n in range(3, _N_CLOSEST + 1):
        rng = np.random.RandomState(42)
        for trio in combinations(range(n), 3):
            tables[n, index_of[trio]] = rng.randn(3, 2) * 1e-3
    return tables


def _circle_fit_np(pts: np.ndarray) -> np.ndarray:
    """Hyper-fit circle center in NumPy float64 (the algebra of
    geo.circle_fit's moment form, Newton on the characteristic polynomial),
    on the host: the reference centers are constants of the known path."""
    mean = pts.mean(axis=0)
    xc = pts[:, 0] - mean[0]
    yc = pts[:, 1] - mean[1]
    zi = xc * xc + yc * yc
    m = lambda p, q: np.mean(p * q)  # noqa: E731
    mxy, mxx, myy = m(xc, yc), m(xc, xc), m(yc, yc)
    mxz, myz, mzz = m(xc, zi), m(yc, zi), m(zi, zi)
    mz = mxx + myy
    cov_xy = mxx * myy - mxy * mxy
    var_z = mzz - mz * mz
    a2 = 4 * cov_xy - 3 * mz * mz - mzz
    a1 = var_z * mz + 4.0 * cov_xy * mz - mxz * mxz - myz * myz
    a0 = mxz * (mxz * myy - myz * mxy) + myz * (myz * mxx - mxz * mxy) - var_z * cov_xy
    a22 = a2 + a2
    x, y = 0.0, a0
    for _ in range(32):
        dy = a1 + x * (a22 + 16.0 * x * x)
        x_new = x - y / (dy if dy != 0 else 1.0)
        y_new = a0 + x_new * (a1 + x_new * (a2 + 4.0 * x_new * x_new))
        if x_new == x or not np.isfinite(x_new) or abs(y_new) >= abs(y):
            break
        x, y = x_new, y_new
    det = x * x - x * mz + cov_xy
    if det == 0:
        det = 1e-12
    cx = (mxz * (myy - x) - myz * mxy) / det / 2.0
    cy = (myz * (mxx - x) - mxz * mxy) / det / 2.0
    return np.asarray([cx + mean[0], cy + mean[1]])


@functools.cache
def _reference_centers() -> np.ndarray:
    """Circle centers of the known path's two lobes
    (skidpad_relocalizer.py:172-183): [right (y<-2), left (y>2)], float64."""
    path = BASE_SKIDPAD_PATH
    neg = path[path[:, 1] < -2]
    pos = path[path[:, 1] > 2]
    return np.stack([_circle_fit_np(neg), _circle_fit_np(pos)]).astype(np.float64)


@functools.lru_cache(maxsize=8)
def _skidpad_constants(device: torch.device, dtype: torch.dtype) -> tuple[Tensor, Tensor, Tensor]:
    """(subset table (1140, 3) int64, noise tables (21, 1140, 3, 2), reference
    centers (2, 2)) on ``device`` in ``dtype``, built once for each pair. The
    noise values are the float32 table's in either dtype."""
    return (
        torch.as_tensor(_subset_table(), dtype=torch.int64, device=device),
        torch.as_tensor(_noise_tables(), device=device).to(dtype),
        torch.as_tensor(_reference_centers(), device=device).to(dtype),
    )


def _norm(v: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def skidpad_accepted_trios(
    cones_xy: Tensor, mask: Tensor, vehicle_position: Tensor
) -> tuple[Tensor, Tensor]:
    """The powerset circle fits of one attempt (skidpad_relocalizer.py:31-64,
    208-212): the 20 closest cones, a circle through each of their 1,140
    trios (jittered by the reference's noise stream) and the gates on radius,
    spacing and residual. Returns (accept (B, 1140), centers (B, 1140, 2),
    non-finite centers zeroed)."""
    if cones_xy.shape[1] < _N_CLOSEST:
        raise ValueError(f"the skidpad relocalizer needs n_cones >= {_N_CLOSEST} (got {cones_xy.shape[1]})")
    dtype = cones_xy.dtype
    subsets, noise_tables, _ = _skidpad_constants(cones_xy.device, dtype)

    # 20 closest cones (:208-212); a stable sort keeps top_k's tie order
    # (lowest index first), masked cones sit at +inf
    dist = torch.where(mask, _norm(cones_xy - vehicle_position[:, None]), torch.full_like(cones_xy[..., 0], math.inf))
    sorted_dist, close_idx = torch.sort(dist, dim=1, stable=True)
    close_idx = close_idx[:, :_N_CLOSEST]
    close = gl.take_rows(cones_xy, close_idx)  # (B, 20, 2)
    close_ok = torch.isfinite(sorted_dist[:, :_N_CLOSEST])

    pts = close[:, subsets]  # (B, S, 3, 2)
    subset_ok = torch.all(close_ok[:, subsets], dim=2)

    # mean nearest-neighbour distance inside the trio
    d2 = geo.cdist_sq(pts, pts)  # (B, S, 3, 3)
    eye = torch.eye(3, dtype=torch.bool, device=pts.device)
    d2 = torch.where(eye, torch.full_like(d2, math.inf), d2)
    nn = torch.sqrt(torch.amin(d2, dim=-1))
    mean_nn = torch.sum(nn, dim=2) / 3

    # the noise a trio receives depends on the count of close cones
    n_close = torch.sum(close_ok, dim=1)
    pts_noisy = pts + noise_tables[n_close]
    circ = geo.circle_fit(pts_noisy)  # (B, S, 3)
    center_s, radius_s = circ[..., :2], circ[..., 2]
    resid = torch.abs(_norm(center_s[:, :, None, :] - pts_noisy) - radius_s[..., None])
    residual = torch.sum(resid, dim=2) / 3

    accept = (
        subset_ok
        & (torch.abs(radius_s - _CIRCLE_RADIUS) < 1.0)
        & (torch.abs(mean_nn - _NN_DIST) < 1.5)
        & (residual < _RESIDUAL_MAX)
    )
    center_s = torch.where(torch.isfinite(center_s), center_s, torch.zeros_like(center_s))
    return accept, center_s


def skidpad_relocalize_once(
    cones_xy: Tensor,  # (B, N, 2)
    mask: Tensor,  # (B, N)
    vehicle_position: Tensor,  # (B, 2)
    origin_position: Tensor,  # (B, 2)
    origin_direction: Tensor,  # (B, 2)
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """One skidpad relocalization attempt per lane
    (skidpad_relocalizer.py:198-240). Returns (ok (B,), rotation (B,),
    translation (B, 2), center (B, 2))."""
    dtype, dev = cones_xy.dtype, cones_xy.device
    accept, center_s = skidpad_accepted_trios(cones_xy, mask, vehicle_position)
    enough = torch.sum(accept, dim=1) >= 3  # (:218-219)

    # compact accepted centers (up to 64)
    order, cvalid = geo.stable_compact(accept, _MAX_CENTERS)
    centers = gl.take_rows(center_s, order)  # (B, 64, 2)

    # DBSCAN(eps=3, min_samples=1) is the connected components of the <=eps
    # graph (every point is core): transitive closure by path doubling,
    # log2(64) squarings of the 0/1 reachability matrix (exact in float32),
    # then label = min reachable index
    iota = torch.arange(_MAX_CENTERS, device=dev)
    pair = cvalid[:, :, None] & cvalid[:, None, :]
    cd = torch.sqrt(geo.cdist_sq(centers, centers))
    adj = (cd <= _DBSCAN_EPS) & pair
    reach = (adj | torch.eye(_MAX_CENTERS, dtype=torch.bool, device=dev)).to(torch.float32)
    for _ in range(6):  # 2^6 = 64 >= _MAX_CENTERS hops
        reach = torch.clamp(torch.matmul(reach, reach), max=1.0)
    labels = torch.amin(torch.where(reach > 0.0, iota[None, None, :], _MAX_CENTERS), dim=2)
    labels = torch.where(cvalid, labels, _MAX_CENTERS)

    # per-cluster medians (component-wise, like np.median over members)
    member = (labels[:, None, :] == labels[:, :, None]) & pair
    med_x = geo.masked_median(centers[:, None, :, 0].expand(member.shape), member)
    med_y = geo.masked_median(centers[:, None, :, 1].expand(member.shape), member)
    medians = torch.stack([med_x, med_y], dim=2)  # (B, 64, 2) one per node

    is_leader = (labels == iota) & cvalid
    n_clusters = torch.sum(is_leader, dim=1)

    # pair of cluster medians separated by ~18.25 m (:78-98)
    sep = _norm(medians[:, :, None, :] - medians[:, None, :, :])
    pair_valid = is_leader[:, :, None] & is_leader[:, None, :] & (iota[:, None] < iota[None, :])
    score = torch.where(pair_valid, torch.abs(_CENTER_SEP - sep), torch.full_like(sep, math.inf))
    score = score.reshape(-1, _MAX_CENTERS * _MAX_CENTERS)
    flat = torch.argmin(score, dim=1)  # first index on ties
    bi, bj = flat // _MAX_CENTERS, flat % _MAX_CENTERS
    # the reference rejects only if best_distance > 0.5 (skidpad_relocalizer.py:89)
    pair_found = (n_clusters > 1) & (torch.amin(score, dim=1) <= 0.5)

    cc = gl.take_rows(medians, torch.stack([bi, bj], dim=1))
    c1, c2 = cc[:, 0], cc[:, 1]

    # left/right assignment in the original vehicle frame (:112-119)
    yaw0 = geo.angle_from_2d_vector(origin_direction)
    f1 = geo.rotate(c1 - origin_position, -yaw0)
    c1_is_right = (f1[:, 1] < 0.0)[:, None]
    right_calc = torch.where(c1_is_right, c1, c2)
    left_calc = torch.where(c1_is_right, c2, c1)
    # both centers on the same side -> reference IndexError -> fail (:237-238)
    f2 = geo.rotate(c2 - origin_position, -yaw0)
    sides_ok = (f1[:, 1] < 0.0) != (f2[:, 1] < 0.0)

    ref_right, ref_left = _skidpad_constants(dev, dtype)[2]

    translation = ref_right - right_calc
    ref_angle = geo.angle_from_2d_vector(ref_left - ref_right)
    calc_angle = geo.angle_from_2d_vector(left_calc - right_calc)
    rotation = ref_angle - calc_angle

    ok = enough & pair_found & sides_ok
    return ok, rotation, translation, ref_right.expand(cones_xy.shape[0], 2)


# ---------------------------------------------------------------------------
# acceleration
# ---------------------------------------------------------------------------

_N_RANSAC = 100


@functools.cache
def _ransac_u() -> np.ndarray:
    """(100, 3) float32 uniforms the acceleration RANSAC draws its trios from."""
    return np.random.default_rng(3).random((_N_RANSAC, 3)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _ransac_u_on(device: torch.device) -> Tensor:
    return torch.as_tensor(_ransac_u(), device=device)


def acceleration_relocalize_once(
    cones_xy: Tensor,  # (B, N, 2)
    mask: Tensor,  # (B, N)
    vehicle_position: Tensor,  # (B, 2)
    vehicle_direction: Tensor,  # (B, 2)
    origin_position: Tensor,  # (B, 2)
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """One acceleration relocalization attempt per lane
    (acceleration_relocalization.py:121-169): RANSAC-style line fit of the
    near-left cone row. Returns (ok, rotation, translation, center)."""
    yaw = geo.angle_from_2d_vector(vehicle_direction)
    local = geo.rotate(cones_xy - vehicle_position[:, None], -yaw[:, None])
    row = mask & (local[..., 1] > 0.0) & (local[..., 1] < 2.0)
    n_row = torch.sum(row, dim=1)

    order, _ = geo.stable_compact(row)
    pts = gl.take_rows(local, order)  # compacted row cones

    # static pseudo-random DISTINCT 3-subsets over the live prefix, by the
    # order-statistics construction (draw from n, n-1, n-2 and shift past
    # the earlier picks). The reference samples without replacement
    # (np.random.choice(n, 3, replace=False), acceleration_relocalization.py:33);
    # with replacement a duplicated point makes any 2-point line exact
    # (SSE ~ 0), so the argmin would always select a degenerate trio. The
    # uniforms stay float32 in either dtype; the casts truncate toward zero.
    u = _ransac_u_on(cones_xy.device)[None]  # (1, 100, 3)
    nn = torch.clamp(n_row, min=3)[:, None]
    i1 = torch.minimum((u[..., 0] * nn).to(torch.int32), nn - 1)
    r2 = torch.minimum((u[..., 1] * (nn - 1)).to(torch.int32), nn - 2)
    i2 = r2 + (r2 >= i1)
    lo = torch.minimum(i1, i2)
    hi = torch.maximum(i1, i2)
    r3 = torch.minimum((u[..., 2] * (nn - 2)).to(torch.int32), nn - 3)
    i3 = r3 + (r3 >= lo)
    i3 = i3 + (i3 >= hi)
    idx = torch.stack([i1, i2, i3], dim=2)  # (B, N_RANSAC, 3) distinct
    sub = gl.take_rows(pts, idx.reshape(idx.shape[0], -1)).reshape(-1, _N_RANSAC, 3, 2)

    x, y = sub[..., 0], sub[..., 1]
    mx = torch.sum(x, dim=2, keepdim=True) / 3
    my = torch.sum(y, dim=2, keepdim=True) / 3
    var = torch.sum((x - mx) ** 2, dim=2)
    cov = torch.sum((x - mx) * (y - my), dim=2)
    slope = cov / torch.clamp(var, min=1e-9)
    intercept = my[..., 0] - slope * mx[..., 0]
    sse = torch.sum((y - (slope[..., None] * x + intercept[..., None])) ** 2, dim=2)
    best = torch.argmin(sse, dim=1)  # first index on ties
    best_slope = torch.take_along_dim(slope, best[:, None], dim=1)[:, 0]

    angle_to_fix = torch.arctan(best_slope) + yaw
    ok = n_row >= 4
    # unified SE(2): p' = R(-angle)(p - origin) -> rot=-angle, t=-origin, c=0
    return ok, -angle_to_fix, -origin_position, torch.zeros_like(origin_position)


@spanned("stage.reloc.attempt")
def attempt_relocalization(
    cfg: PlannerConfig,
    state: RelocState,
    cones_xy: Tensor,
    mask: Tensor,
    position: Tensor,
    direction: Tensor,
) -> RelocState:
    """Reference Relocalizer.attempt_relocalization_calculation
    (relocalization_base_class.py:50-75): store the first pose, retry every
    frame until a transform is found, then freeze. Every select is per lane:
    a batch may hold relocalized and not yet relocalized lanes."""
    has = state.has_origin[:, None]
    origin_pos = torch.where(has, state.origin_position, position)
    origin_dir = torch.where(has, state.origin_direction, direction)

    if cfg.mission.name == "skidpad":
        ok, rot, trans, center = skidpad_relocalize_once(
            cones_xy, mask, position, origin_pos, origin_dir
        )
    else:
        ok, rot, trans, center = acceleration_relocalize_once(
            cones_xy, mask, position, direction, origin_pos
        )

    take = ok & ~state.relocalized
    return RelocState(
        has_origin=torch.ones_like(state.has_origin),
        origin_position=origin_pos,
        origin_direction=origin_dir,
        relocalized=state.relocalized | ok,
        rotation=torch.where(take, rot, state.rotation),
        translation=torch.where(take[:, None], trans, state.translation),
        center=torch.where(take[:, None], center, state.center),
    )
