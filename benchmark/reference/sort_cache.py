"""Plain NumPy reference of the sorting-result cache's hit rule, float64.

The upstream planner's fast mode (``experimental_performance_improvements``)
keeps, for each side, the start cones and the whole flattened map of the
last frame, and skips the sorter where this frame's start cones and map
each stand within 0.1 m of the last frame's (upstream
``core_trace_sorter.py:57-86``, the similarity test, and ``:189-250``, its
use): same number of cones, every cone within the threshold of its nearest
counterpart, and that counterpart of the same colour. The entry is rebuilt
from every frame, so the rule reads two frames alone, the previous and the
current. The planner under test reuses the cached order only when both
sides hit, and so does this reference.

A frame is the benchmark's (`harness/frames.py::Frame`): five per-type
(k, 2) cone lists in wire order (unknown, right, left, two orange kinds),
the car's position and heading. The start cones of a side are the
reference planner's (`reference/planner.py::start_cones`) on that side's
border. Nothing of the program under test is imported.
"""

from __future__ import annotations

import numpy as np

from reference.planner import start_cones

THRESHOLD_M = 0.1
RIGHT, LEFT = 1, 2  # wire codes: the index of a side's list in a frame


def flattened(cones: list) -> np.ndarray:
    """The five per-type lists as one (N, 3) [x, y, colour] array, types in
    order."""
    rows = [np.concatenate([np.asarray(c, np.float64).reshape(-1, 2),
                            np.full((len(c), 1), float(t))], axis=1)
            for t, c in enumerate(cones) if len(c)]
    return np.concatenate(rows) if rows else np.zeros((0, 3))


def start_rows(frame, side: int) -> np.ndarray:
    """(k, 3) [x, y, colour] of the start cones of side ``side``."""
    border = np.asarray(frame.cones[side], np.float64).reshape(-1, 2)
    idx = start_cones(border, np.asarray(frame.position, np.float64),
                      np.asarray(frame.direction, np.float64)) if len(border) else []
    return np.concatenate([border[idx], np.full((len(idx), 1), float(side))], axis=1)


def largest_distance(a: np.ndarray, b: np.ndarray) -> float:
    """The largest distance of a cone of ``a`` to its nearest counterpart
    in ``b``, in metres: inf where the two differ in number of cones or a
    nearest counterpart differs in colour, 0.0 where both are empty."""
    if a.shape != b.shape:
        return float("inf")
    if len(a) == 0:
        return 0.0
    d = np.linalg.norm(a[:, None, :2] - b[None, :, :2], axis=-1)
    if np.any(a[:, 2] != b[d.argmin(axis=1), 2]):
        return float("inf")
    return float(d.min(axis=1).max())


def distances(previous, current) -> dict:
    """Each test's largest distance (``largest_distance``) from the current
    frame to the previous one."""
    return {
        "start_left": largest_distance(start_rows(current, LEFT), start_rows(previous, LEFT)),
        "start_right": largest_distance(start_rows(current, RIGHT), start_rows(previous, RIGHT)),
        "map": largest_distance(flattened(current.cones), flattened(previous.cones)),
    }


def is_hit(previous, current) -> bool:
    """Whether the current frame reuses the previous frame's sorted order:
    no previous frame is a miss; else every test within the threshold."""
    if previous is None:
        return False
    return all(d < THRESHOLD_M for d in distances(previous, current).values())


def hit_sequence(frames: list) -> list[bool]:
    """Hit or miss of each of ``frames``, driven in order by one planner."""
    return [is_hit(prev, cur) for prev, cur in zip([None] + frames[:-1], frames)]
