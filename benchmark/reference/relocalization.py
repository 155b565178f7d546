"""Plain NumPy reference of the skidpad relocalizer, float64.

The upstream skidpad relocalizer (`skidpad_relocalizer.py` of
ft-fsd-path-planning), as the planner specifies it: the 20 cones nearest
the car; a circle through every trio of them, each point moved by the
upstream's fixed jitter (``RandomState(42)``, ``1e-3 * randn(3, 2)`` per
trio in ``combinations`` order); trios kept whose circle has a radius
within 1 m of 7.625 m, a mean nearest-neighbour spacing within 1.5 m of
2.4 m and a mean residual under 0.4 m; at least three of them; their
centres clustered (DBSCAN, eps 3 m, one sample) and each cluster's median
taken; the two medians whose distance is nearest 18.25 m (within 0.5 m),
told right from left in the frame of the first pose; the transform that
puts them on the known path's two circle centres.
"""

from __future__ import annotations

import functools
import math
from itertools import combinations

import numpy as np

from reference.planner import circle_fit

N_CLOSEST = 20
RADIUS, RADIUS_TOL = 7.625, 1.0
NN_DIST, NN_TOL = 2.4, 1.5
RESIDUAL_MAX = 0.4
CENTER_SEP, SEP_TOL = 18.25, 0.5
DBSCAN_EPS = 3.0


@functools.cache
def _trios_and_jitter(n: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.RandomState(42)
    trios = np.asarray(list(combinations(range(n), 3)))
    jitter = np.stack([rng.randn(3, 2) * 1e-3 for _ in trios])
    return trios, jitter


def _rot(v: np.ndarray, theta: float) -> np.ndarray:
    c, s = math.cos(theta), math.sin(theta)
    return np.stack([c * v[..., 0] - s * v[..., 1], s * v[..., 0] + c * v[..., 1]], axis=-1)


def lobe_centers(known_path: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The known path's right (y < -2) and left (y > 2) circle centres."""
    right = np.asarray(circle_fit(known_path[known_path[:, 1] < -2])[:2])
    left = np.asarray(circle_fit(known_path[known_path[:, 1] > 2])[:2])
    return right, left


def relocalize(cones: np.ndarray, position: np.ndarray, origin_position: np.ndarray,
               origin_direction: np.ndarray, known_path: np.ndarray):
    """(rotation, right centre as found, right centre of the known path),
    or None where this frame does not relocalize. A map point ``p`` lies at
    ``R(rotation) (p - found) + known`` in the known frame."""
    order = np.argsort(np.linalg.norm(cones - position, axis=1), kind="stable")[:N_CLOSEST]
    close = cones[order]
    trios, jitter = _trios_and_jitter(len(close))
    centers = []
    for trio, noise in zip(trios, jitter):
        pts = close[trio]
        d = np.linalg.norm(pts[:, None] - pts[None], axis=2)
        np.fill_diagonal(d, np.inf)
        mean_nn = float(np.mean(d.min(axis=1)))
        noisy = pts + noise
        cx, cy, r = circle_fit(noisy)
        residual = float(np.mean(np.abs(np.linalg.norm(noisy - [cx, cy], axis=1) - r)))
        if abs(r - RADIUS) < RADIUS_TOL and abs(mean_nn - NN_DIST) < NN_TOL and residual < RESIDUAL_MAX:
            centers.append((cx, cy))
    if len(centers) < 3:
        return None
    centers = np.asarray(centers)
    # DBSCAN with one sample a core: the connected components of the eps graph
    labels = -np.ones(len(centers), int)
    for i in range(len(centers)):
        if labels[i] >= 0:
            continue
        labels[i], todo = i, [i]
        while todo:
            j = todo.pop()
            near = np.flatnonzero((np.linalg.norm(centers - centers[j], axis=1) <= DBSCAN_EPS) & (labels < 0))
            labels[near] = i
            todo.extend(near.tolist())
    leaders = sorted(set(labels.tolist()))
    if len(leaders) < 2:
        return None
    medians = [np.median(centers[labels == lab], axis=0) for lab in leaders]
    best, pair = math.inf, None
    for a in range(len(leaders)):
        for b in range(a + 1, len(leaders)):
            score = abs(CENTER_SEP - float(np.linalg.norm(medians[a] - medians[b])))
            if score < best:
                best, pair = score, (a, b)
    if best > SEP_TOL:
        return None
    c1, c2 = medians[pair[0]], medians[pair[1]]
    yaw0 = math.atan2(origin_direction[1], origin_direction[0])
    y1 = _rot(c1 - origin_position, -yaw0)[1]
    y2 = _rot(c2 - origin_position, -yaw0)[1]
    if (y1 < 0) == (y2 < 0):
        return None
    right, left = (c1, c2) if y1 < 0 else (c2, c1)
    ref_right, ref_left = lobe_centers(known_path)
    rotation = math.atan2(*(ref_left - ref_right)[::-1]) - math.atan2(*(left - right)[::-1])
    return rotation, right, ref_right


class Transform:
    """The map-to-known transform a relocalization found."""

    def __init__(self, rotation: float, found: np.ndarray, known: np.ndarray):
        self.rotation, self.found, self.known = rotation, found, known

    def to_known(self, p: np.ndarray) -> np.ndarray:
        return _rot(p - self.found, self.rotation) + self.known

    def to_map(self, p: np.ndarray) -> np.ndarray:
        return _rot(p - self.known, -self.rotation) + self.found
