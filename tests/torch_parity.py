"""Shared helpers of the PyTorch-port tests: lateral path comparison in
NumPy and identical seeded inputs for both packages.

Paths are compared laterally over their common arc span: float
reassociation can move the 20 m trim by one 0.165 m tail sample without
moving the curve (ARCHITECTURE.md "Parity strategy").
"""

from __future__ import annotations

import numpy as np


def curve_deviation(pts_a: np.ndarray, pts_b: np.ndarray) -> float:
    """Max over points of A of the distance to the densified polyline B."""
    dense_t = np.linspace(0, len(pts_b) - 1, 4000)
    bx = np.interp(dense_t, np.arange(len(pts_b)), pts_b[:, 0])
    by = np.interp(dense_t, np.arange(len(pts_b)), pts_b[:, 1])
    dense_b = np.stack([bx, by], axis=1)
    d = np.linalg.norm(pts_a[:, None] - dense_b[None], axis=2)
    return float(d.min(axis=1).max())


def path_parity_deviation(ref_path: np.ndarray, our_path: np.ndarray) -> float:
    """Symmetric curve deviation of two (H, 4) paths over their common span."""
    span = min(ref_path[-1, 0], our_path[-1, 0]) + 1e-6
    ref_q = ref_path[ref_path[:, 0] <= span, 1:3]
    our_q = our_path[our_path[:, 0] <= span, 1:3]
    return max(
        curve_deviation(our_q, ref_path[:, 1:3]),
        curve_deviation(ref_q, our_path[:, 1:3]),
    )


def seeded_traces(seed: int, batch: int, m: int, noise: float = 0.05, live: tuple[int, int] | None = None):
    """(points (B, M, 2) f32, mask (B, M)) of sine-shaped traces of varying
    length (3..M valid points, or ``live`` = (lo, hi)) with Gaussian noise."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((batch, m, 2), np.float32)
    mask = np.zeros((batch, m), bool)
    lengths = np.linspace(*(live or (3, m)), batch).astype(int)
    for b, n in enumerate(lengths):
        x = np.linspace(0.0, 1.5 * n, n)
        y = 6.0 * np.sin(x / 9.0 + b) + rng.normal(0.0, noise, n)
        pts[b, :n] = np.stack([x, y], axis=1)
        mask[b, :n] = True
    return pts, mask
