"""Plain NumPy/SciPy reference of one planner frame, float64.

The cone order and the cone pairs come from how the benchmark built the
track: the border cones of one side are numbered along the driving
direction, and cone ``k`` on the left stands opposite cone ``k`` on the
right. A correct sorter returns, from its start cones on, the next border
cones in that order (at most ``max_length``); a correct matcher pairs the
cones of one station. The start cones follow the planner's rule: the
closest own-colour cone inside the search ellipse in front of the car and
the closest one behind it, within ``max_dist_to_first``.

The path is then worked out as the planner's path calculation specifies it
(centerline of matched pairs, smoothing spline with ``s = 0.2``, 0.1 m
samples, connect to the car, extend to the horizon, drop what lies behind
the car, refit, trim to 20 m, refit with ``s = 0.01``, windowed circle-fit
curvature, 40 samples), with SciPy's FITPACK for every fit.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.interpolate import splev, splprep
from scipy.ndimage import uniform_filter1d

MAX_LENGTH = 12  # sorter: cones a side
MAX_DIST = 6.5
MAX_DIST_TO_FIRST = 6.0
SMOOTHING = 0.2
REFIT_SMOOTHING = 0.01
PREDICT_EVERY = 0.1
MPC_PATH_LENGTH = 20.0
HORIZON = 40
RADIUS_MIN, RADIUS_MAX = 1.0, 3000.0
MAX_VALID_DISTANCE = 5.0


def _rot(v: np.ndarray, theta: float) -> np.ndarray:
    c, s = math.cos(theta), math.sin(theta)
    return np.stack([c * v[..., 0] - s * v[..., 1], s * v[..., 0] + c * v[..., 1]], axis=-1)


def _angle_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    na = np.linalg.norm(a, axis=-1)
    nb = np.linalg.norm(b, axis=-1)
    cos = np.sum(a * b, axis=-1) / np.maximum(na * nb, 1e-12)
    return np.arccos(np.clip(cos, -1.0, 1.0))


def start_cones(border: np.ndarray, position: np.ndarray, direction: np.ndarray) -> list[int]:
    """Indices of the start cones of one border (behind first), [] if none."""
    yaw = math.atan2(direction[1], direction[0])
    rel = _rot(border - position, -yaw)
    dist = np.linalg.norm(rel, axis=1)
    major, minor = MAX_DIST_TO_FIRST * 1.5, MAX_DIST_TO_FIRST / 1.5
    inside = (rel[:, 0] / major) ** 2 + (rel[:, 1] / minor) ** 2 < 1.0
    d1 = np.where(inside, dist, np.inf)
    i1 = int(np.argmin(d1))
    if d1[i1] > MAX_DIST_TO_FIRST:
        return []
    behind = _angle_between(border - position, direction[None]) >= math.pi / 2
    d2 = np.where(inside & behind, dist, np.inf)
    d2[i1] = np.inf
    i2 = int(np.argmin(d2))
    if d2[i2] > MAX_DIST_TO_FIRST:
        return [i1]
    chord = border[i1] - border[i2]
    if _angle_between(chord, direction) > _angle_between(-chord, direction):
        i1, i2 = i2, i1
    dd = float(np.linalg.norm(chord))
    if dd > MAX_DIST * 1.1 or dd < 1.4:
        return [i1]
    return [i2, i1]


def sorted_border(border: np.ndarray, position: np.ndarray, direction: np.ndarray) -> list[int]:
    """The border's cone indices in driving order from its start cones."""
    start = start_cones(border, position, direction)
    if not start:
        return []
    n = len(border)
    order = list(start)
    while len(order) < min(MAX_LENGTH, n):
        order.append((order[-1] + 1) % n)
    return order


# ---------------------------------------------------------------------------
# splines
# ---------------------------------------------------------------------------


def _chord(points: np.ndarray) -> np.ndarray:
    return np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(points, axis=0), axis=1))])


def _fit(points: np.ndarray, smoothing: float):
    """FITPACK smoothing spline over the chord parameter; None where
    ``splprep`` refuses the points."""
    u = _chord(points)
    if len(points) < 2 or np.any(np.diff(u) <= 1e-9):
        return None, u
    k = min(3, len(points) - 1)
    tck, _ = splprep([points[:, 0], points[:, 1]], u=u, s=smoothing, k=k)
    return tck, u


def _eval_every(tck, every: float, max_u: float, limit: int) -> tuple[np.ndarray, np.ndarray]:
    n = min(limit, int(math.ceil(max_u / every)) + 1)
    grid = np.arange(n) * every
    grid = grid[grid < max_u]
    x, y = splev(grid, tck)
    return np.stack([x, y], axis=1), grid


# ---------------------------------------------------------------------------
# curvature
# ---------------------------------------------------------------------------


def circle_fit(points: np.ndarray) -> tuple[float, float, float]:
    """Hyper circle fit (Al-Sharadqah and Chernov) -> (cx, cy, r)."""
    mean = points.mean(axis=0)
    xc, yc = points[:, 0] - mean[0], points[:, 1] - mean[1]
    zi = xc * xc + yc * yc
    mxy, mxx, myy = np.mean(xc * yc), np.mean(xc * xc), np.mean(yc * yc)
    mxz, myz, mzz = np.mean(xc * zi), np.mean(yc * zi), np.mean(zi * zi)
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
        if x_new == x or not math.isfinite(x_new) or abs(y_new) >= abs(y):
            break
        x, y = x_new, y_new
    det = x * x - x * mz + cov_xy
    det = math.copysign(max(abs(det), 1e-12), det if det != 0 else 1.0)
    cx = (mxz * (myy - x) - myz * mxy) / det / 2.0
    cy = (myz * (mxx - x) - mxz * mxy) / det / 2.0
    return cx + mean[0], cy + mean[1], math.sqrt(abs(cx * cx + cy * cy + mz))


def _orientation(p0, p1, p2) -> float:
    return float(np.sign((p1[0] - p0[0]) * (p2[1] - p0[1]) - (p1[1] - p0[1]) * (p2[0] - p0[0])))


def path_curvature(points: np.ndarray, window: int) -> np.ndarray:
    """Signed curvature from a circle through each sample's window."""
    n, half = len(points), (window - 1) // 2
    out = np.zeros(n)
    for i in range(n):
        w = points[max(0, i - half): min(n, i + half + 1)]
        radius = min(max(circle_fit(w)[2], RADIUS_MIN), RADIUS_MAX)
        mid = min(len(w) // 2, len(w) - 1)
        out[i] = _orientation(w[0], w[mid], w[-1]) / radius
    return out


# ---------------------------------------------------------------------------
# the path chain
# ---------------------------------------------------------------------------


def _connect_to_car(path: np.ndarray, position: np.ndarray, direction: np.ndarray) -> np.ndarray:
    to_first = path[0] - position
    dist = float(np.linalg.norm(to_first))
    if dist < 0.5 or _angle_between(to_first, direction) > math.pi / 2:
        return path
    return np.concatenate([[position + to_first / max(dist, 1e-12) * 0.2], path])


def _extend(path: np.ndarray, position: np.ndarray, direction: np.ndarray) -> np.ndarray:
    """Append an arc or a ray where less than the horizon lies in front."""
    n = len(path)
    in_front = (path - position) @ direction > 0
    in_front = np.maximum.accumulate(in_front) | (np.arange(n) >= n - 20)
    seg = np.linalg.norm(np.diff(path, axis=0), axis=1)
    front = float(np.sum(seg[in_front[1:] & in_front[:-1]]))
    if front > MPC_PATH_LENGTH:
        return path
    relevant = path[-20:]
    cx, cy, r = circle_fit(relevant)
    radius = min(max(r, 10.0), 100.0)
    centered = relevant - np.array([cx, cy])
    sign = _orientation(centered[0], centered[len(centered) // 2], centered[-1])
    start = math.atan2(centered[0, 1], centered[0, 0])
    angles = np.linspace(start, start + sign * math.pi, 50)
    if radius < 80.0:
        arc = np.stack([np.cos(angles), np.sin(angles)], axis=1) * radius
        ext = (arc - arc[:1] + path[-1])[1:]
    else:
        d = path[-1] - path[-2]
        d = d / max(np.linalg.norm(d), 1e-12)
        ext = path[-1] + d * np.arange(1, 30)[:, None]
    return np.concatenate([path, ext])


def _behind_removed(path: np.ndarray, position: np.ndarray) -> np.ndarray:
    return path[int(np.argmin(np.linalg.norm(path - position, axis=1))):]


def _trimmed(path: np.ndarray) -> np.ndarray:
    cum = np.cumsum(np.linalg.norm(np.diff(path, axis=0), axis=1))
    over = np.flatnonzero(cum > MPC_PATH_LENGTH)
    return path[: over[0]] if len(over) else path


def parameterize(path: np.ndarray) -> np.ndarray | None:
    """(n, 2) trace -> (40, 4) [s, x, y, curvature]; None where too short."""
    seg = np.linalg.norm(np.diff(path, axis=0), axis=1)
    first10 = min(max(len(seg), 1), 10)
    mean_dist = float(np.sum(seg[:first10])) / first10
    every = float(np.sum(seg)) / HORIZON / 3.0
    skip = max(int(every / max(mean_dist, 1e-9)), 1)
    tck, _ = _fit(path[::skip][:256], REFIT_SMOOTHING)
    if tck is None:
        return None
    u_max = tck[0][-1]
    pts, grid = _eval_every(tck, every, u_max, 192)
    n = len(pts)
    if n < HORIZON:
        return None
    window = min(n // 5, 30)
    window += window % 2 == 0
    curv = path_curvature(pts, window)
    curv = uniform_filter1d(curv, size=max(window // 2, 2), mode="nearest")
    idx = np.linspace(0, n - 1, HORIZON).astype(int)
    return np.stack([grid[idx], pts[idx, 0], pts[idx, 1], curv[idx]], axis=1)


def centerline_path(center: np.ndarray, position: np.ndarray, direction: np.ndarray) -> np.ndarray | None:
    """The path calculation from centerline points on; None where it
    would fall back to the previous path."""
    tck, u = _fit(center, SMOOTHING)
    if tck is None:
        return None
    dense, _ = _eval_every(tck, PREDICT_EVERY, u[-1], 512)
    if np.min(np.linalg.norm(dense - position, axis=1)) > MAX_VALID_DISTANCE:
        return None
    path = _connect_to_car(dense, position, direction)
    path = _extend(path, position, direction)
    path = _behind_removed(path, position)
    tck, _ = _fit(path, SMOOTHING)
    if tck is None:
        return None
    dense, _ = _eval_every(tck, PREDICT_EVERY, MPC_PATH_LENGTH * 1.5, 512)
    dense = _trimmed(dense)
    if len(dense) <= 2:
        return None
    return parameterize(dense)


def trackdrive_path(
    left: np.ndarray, right: np.ndarray, position: np.ndarray, direction: np.ndarray
) -> np.ndarray | None:
    """One trackdrive frame: borders (n, 2) numbered along the track, cone
    ``k`` of one side opposite cone ``k`` of the other."""
    order_l = sorted_border(left, position, direction)
    order_r = sorted_border(right, position, direction)
    if len(order_l) < 3 and len(order_r) < 3:
        return None
    base, other = (order_l, order_r) if len(order_l) >= len(order_r) else (order_r, order_l)
    paired = [k for k in base if k in set(other)]
    if len(paired) < 2:
        return None
    center = (left[paired] + right[paired]) / 2.0
    return centerline_path(center, position, direction)


def skidpad_path(known: np.ndarray, poses: list) -> np.ndarray | None:
    """The skidpad path in the known frame at the last of ``poses`` (the
    car's (position, heading) in the known frame, frame by frame since the
    start of the run): the window of the known path from the point nearest
    the car, tracked frame to frame within 20 m of the previous point, 25 m
    long; then the path calculation, with the path behind the car dropped
    first."""
    seg = np.linalg.norm(np.diff(known[:10], axis=0), axis=1)
    mean_distance = max(float(np.mean(seg)), 1e-6)
    max_change = int(20.0 / mean_distance)
    index = 0
    for position, _ in poses:
        lo, hi = max(index - max_change, 0), min(index + max_change, len(known))
        index = lo + int(np.argmin(np.linalg.norm(known[lo:hi] - position, axis=1)))
    position, heading = poses[-1]
    dense = known[index: min(index + int(25.0 / mean_distance), len(known))]
    if np.min(np.linalg.norm(dense - position, axis=1)) > MAX_VALID_DISTANCE:
        return None
    dense = _behind_removed(dense, position)
    path = _connect_to_car(dense, position, heading)
    path = _extend(path, position, heading)
    path = _behind_removed(path, position)
    tck, _ = _fit(path, SMOOTHING)
    if tck is None:
        return None
    dense, _ = _eval_every(tck, PREDICT_EVERY, MPC_PATH_LENGTH * 1.5, 512)
    dense = _trimmed(dense)
    if len(dense) <= 2:
        return None
    return parameterize(dense)
