"""Known mission paths, generated from the official track geometry.

The reference ships a hardcoded 5786x2 skidpad point table
(`relocalization/skidpad/skidpad_path_data.py`) and generates the
acceleration path at import (`acceleration_relocalization.py:175-210`). Both
are reproduced here *from the underlying FSG track geometry* (not copied):

Skidpad (FSG rules / measured from the reference table's structure):
  - entry straight x in [-20, 0] along y = 0
  - two full right-hand laps: circle of radius 9.125 m centered (0, -9.125)
  - two full left-hand laps: circle of radius 9.125 m centered (0, +9.125)
  - exit straight x in [0, 40]
  - ~0.05 m point spacing, tiny y-noise so downstream spline fits never see
    exactly collinear points (the reference table has the same jitter)

Acceleration: 0.2 m-step rectangle -10..150 m with sigma=0.01 noise
(seeded), matching the reference generator's shape.
"""

from __future__ import annotations

import numpy as np

_SKIDPAD_SPACING = 0.05  # reference table spacing: 0.0500 +- 0.0002

# Track geometry surveyed from the reference table (least-squares circle fit
# per driven lap, line fit per straight — the same fits the relocalizer
# itself performs, skidpad_relocalizer.py:172-183). These are parity-spec
# constants, like the cost weights: the relocalizer's reference centers and
# every tracked path point derive from them, so using the ideal FSG values
# (0, -+9.125), r=9.125 offsets the whole mission output by ~5.5 cm. The
# reference's path is a recorded drive, not ideal geometry: its four laps
# are four *different* near-circles (lap-to-lap lateral deviation up to
# ~6.5 cm), so each lap is modeled with its own fitted circle.
_LAPS = (  # (cx, cy, r), driving order: right x2 (clockwise), left x2 (ccw)
    (0.0548, -9.1410, 9.1217),
    (0.0550, -9.1418, 9.1211),
    (0.0550, 9.1223, 9.1231),
    (0.0553, 9.1217, 9.1235),
)
_ENTRY_LINE = (0.000384, 0.005219)  # (slope, intercept), x in [-20, 0)
_EXIT_LINE = (0.000237, -0.006246)  # x in [0, 40)


def _circle_points(center: np.ndarray, radius: float, start_angle: float,
                   end_angle: float, spacing: float) -> np.ndarray:
    arc_len = abs(end_angle - start_angle) * radius
    n = int(round(arc_len / spacing))
    ang = np.linspace(start_angle, end_angle, n, endpoint=False)
    return center + radius * np.stack([np.cos(ang), np.sin(ang)], axis=1)


def _resample(path: np.ndarray, spacing: float) -> np.ndarray:
    """Uniform arc-length resampling (the reference table is exactly
    0.05 m-spaced, which a piecewise construction with junction steps isn't)."""
    seg = np.linalg.norm(np.diff(path, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    su = np.arange(0.0, s[-1], spacing)
    x = np.interp(su, s, path[:, 0])
    y = np.interp(su, s, path[:, 1])
    return np.stack([x, y], axis=1)


def generate_skidpad_path() -> np.ndarray:
    rng = np.random.default_rng(7)
    spacing = _SKIDPAD_SPACING

    entry_x = np.arange(-20.0, 0.0, spacing)
    entry = np.stack(
        [entry_x, _ENTRY_LINE[0] * entry_x + _ENTRY_LINE[1]], axis=1
    )

    # each lap starts/ends at its junction-facing angle (toward the origin);
    # the measured centers put the origin ~1 cm off the circles, which the
    # uniform resampling below blends through. Right laps run clockwise,
    # left laps counter-clockwise (driving order).
    laps = []
    for i, (cx, cy, r) in enumerate(_LAPS):
        center = np.array([cx, cy])
        a0 = np.arctan2(-cy, -cx)
        sweep = -2 * np.pi if i < 2 else 2 * np.pi
        laps.append(_circle_points(center, r, a0, a0 + sweep, spacing))

    exit_x = np.arange(0.0, 40.0, spacing)
    exit_ = np.stack([exit_x, _EXIT_LINE[0] * exit_x + _EXIT_LINE[1]], axis=1)

    path = np.concatenate([entry, *laps, exit_])
    path = _resample(path, spacing)
    path = path + rng.normal(0.0, 1e-3, path.shape)
    return path.astype(np.float64)


def generate_acceleration_path() -> np.ndarray:
    """Same shape as the reference generator (acceleration_relocalization.py:
    175-207): out along +x, across, back, across."""
    rng = np.random.default_rng(42)
    path_x = np.arange(-10, 150, 0.2)
    path_y = rng.normal(0, 0.01, len(path_x))

    path_2_y = np.arange(0, 5, 0.2)
    path_2_x = rng.normal(0, 0.01, len(path_2_y)) + path_x[-1]

    path_3_x = path_x[::-1]
    path_3_y = path_y[::-1] + path_2_y[-1]

    path_4_y = path_2_y[::-1]
    path_4_x = rng.normal(0, 0.01, len(path_4_y)) + path_x[0]

    xs = np.concatenate([path_x, path_2_x, path_3_x, path_4_x])
    ys = np.concatenate([path_y, path_2_y, path_3_y, path_4_y])
    return np.stack([xs, ys], axis=1)


BASE_SKIDPAD_PATH = generate_skidpad_path()
BASE_ACCELERATION_PATH = generate_acceleration_path()
