"""How far a served path lies from the reference's path.

Paths are compared laterally over their common span: each point of one path
is measured to the other path's polyline, where its foot falls inside that
polyline, and the widest such distance, both ways, is the frame's gap. The
20 m trim and the 40-sample pick move the ends by a sample between two
builds, so a pointwise difference would read the sample spacing rather than
a fault. Curvature is compared at the reference sample nearest each served
point.
"""

from __future__ import annotations

import numpy as np


def _point_to_polyline(points: np.ndarray, line: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(distance, inside) of each point to the polyline ``line``: inside is
    False where the nearest foot is an end point of the polyline and the
    point lies beyond it."""
    a, b = line[:-1], line[1:]
    ab = b - a
    ab2 = np.maximum(np.sum(ab * ab, axis=1), 1e-18)
    t = np.einsum("pij,ij->pi", points[:, None, :] - a[None], ab) / ab2
    tc = np.clip(t, 0.0, 1.0)
    foot = a[None] + tc[..., None] * ab[None]
    d = np.linalg.norm(points[:, None, :] - foot, axis=2)
    seg = np.argmin(d, axis=1)
    rows = np.arange(len(points))
    t_at = t[rows, seg]
    beyond = ((seg == 0) & (t_at < 0.0)) | ((seg == len(ab) - 1) & (t_at > 1.0))
    return d[rows, seg], ~beyond


def lateral_gap(path: np.ndarray, ref: np.ndarray) -> float:
    """Widest lateral distance between two (40, >=3) [s, x, y, ...] paths
    over their common span, in metres."""
    p, r = path[:, 1:3], ref[:, 1:3]
    d1, in1 = _point_to_polyline(p, r)
    d2, in2 = _point_to_polyline(r, p)
    gaps = np.concatenate([d1[in1], d2[in2]])
    return float(np.max(gaps)) if len(gaps) else float("inf")


def curvature_gap(path: np.ndarray, ref: np.ndarray) -> float:
    """Widest curvature difference (1/m) at the reference sample nearest
    each served point."""
    d = np.linalg.norm(path[:, None, 1:3] - ref[None, :, 1:3], axis=2)
    nearest = np.argmin(d, axis=1)
    return float(np.max(np.abs(path[:, 3] - ref[nearest, 3])))
