"""Curated algorithm-stress scenarios — the reference's streamlit fixture
library (`demo/streamlit_demo/common.py:72-324`) as plain data functions.

Counterpart of `ft_fsd_path_planning_tpu/demo/scenarios.py`, NumPy only:
the same arrays, bit for bit.

Each scenario returns (cones_by_type list, car_position, car_direction) in
the reference's input format, so they drive both the interactive demo and the
regression tests.
"""

from __future__ import annotations

import numpy as np

from ft_fsd_path_planning_torch.utils.cone_types import ConeTypes


def _lists(left=None, right=None, unknown=None):
    lists = [np.zeros((0, 2)) for _ in range(5)]
    if left is not None:
        lists[ConeTypes.LEFT] = np.asarray(left, float)
    if right is not None:
        lists[ConeTypes.RIGHT] = np.asarray(right, float)
    if unknown is not None:
        lists[ConeTypes.UNKNOWN] = np.asarray(unknown, float)
    return lists


def _corridor(n, width, spacing, curv, phase=0.0):
    s = np.arange(n) * spacing
    if abs(curv) < 1e-9:
        center = np.stack([s, np.zeros(n)], axis=1)
        normal = np.tile([[0.0, 1.0]], (n, 1))
    else:
        radius = 30.0 / curv
        ang = s / radius + phase
        center = radius * np.stack(
            [np.sin(ang) - np.sin(phase), np.cos(phase) - np.cos(ang)], axis=1
        )
        normal = np.stack([-np.sin(ang), np.cos(ang)], axis=1)
    return center + normal * width / 2, center - normal * width / 2


def straight():
    left, right = _corridor(10, 3.0, 3.5, 0.0)
    return _lists(left=left, right=right), np.array([0.0, 0.0]), np.array([1.0, 0.0])


def simple_corner():
    left, right = _corridor(12, 3.0, 3.5, 0.9)
    return _lists(left=left, right=right), np.array([0.0, 0.0]), np.array([1.0, 0.0])


def corner_missing_blue():
    left, right = _corridor(12, 3.0, 3.5, 0.9)
    left = np.delete(left, [4, 5, 6], axis=0)
    return _lists(left=left, right=right), np.array([0.0, 0.0]), np.array([1.0, 0.0])


def corner_missing_yellow():
    left, right = _corridor(12, 3.0, 3.5, -0.9)
    right = np.delete(right, [4, 5, 6], axis=0)
    return _lists(left=left, right=right), np.array([0.0, 0.0]), np.array([1.0, 0.0])


def hairpin():
    # tight 180-degree turn
    left, right = _corridor(16, 3.0, 2.4, 2.6)
    return _lists(left=left, right=right), np.array([0.0, 0.0]), np.array([1.0, 0.0])


def colorless_straight():
    left, right = _corridor(9, 3.0, 3.5, 0.0)
    return (
        _lists(unknown=np.concatenate([left, right])),
        np.array([0.0, 0.0]),
        np.array([1.0, 0.0]),
    )


def noisy_corner(seed: int = 0, sigma: float = 0.12):
    rng = np.random.default_rng(seed)
    left, right = _corridor(12, 3.0, 3.5, 0.7)
    left = left + rng.normal(0, sigma, left.shape)
    right = right + rng.normal(0, sigma, right.shape)
    return _lists(left=left, right=right), np.array([0.0, 0.0]), np.array([1.0, 0.0])


def hairpin_extreme():
    """Hairpin with the inner wall's tail shoved into the track (the
    reference's 'Hairpin Extreme', common.py:175-180: last 7 right cones
    shifted by (-1, +1)) — stresses the sorter's direction gates and the
    matcher's discard guard."""
    cones, pos, direction = hairpin()
    right = cones[ConeTypes.RIGHT].copy()
    right[-7:] += [-1.0, 1.0]
    cones[ConeTypes.RIGHT] = right
    return cones, pos, direction


def wrong_sort():
    """One-sided cone chain with a long gap and a hook at the end (the
    reference's 'Wrong sort', common.py:182-188): naive nearest-neighbour
    ordering jumps the gap and doubles back — the trace sorter must not."""
    # curving left-side wall ...
    ang = np.linspace(0.4, 1.9, 8)
    arc = np.stack([16.0 - 7.0 * np.cos(ang - 0.4), 17.0 - 9.0 * np.sin(2.0 - ang)], axis=1)
    # ... then a ~7.5 m gap straight down and a hook back toward the wall
    tail = np.array([[11.5, -7.9], [7.8, -10.7]])
    left = np.concatenate([arc, tail])
    return _lists(left=left), np.array([14.0, 18.5]), np.array([0.2, -1.0]) / np.linalg.norm([0.2, -1.0])


ALL_SCENARIOS = {
    "straight": straight,
    "simple_corner": simple_corner,
    "corner_missing_blue": corner_missing_blue,
    "corner_missing_yellow": corner_missing_yellow,
    "hairpin": hairpin,
    "hairpin_extreme": hairpin_extreme,
    "wrong_sort": wrong_sort,
    "colorless_straight": colorless_straight,
    "noisy_corner": noisy_corner,
}
