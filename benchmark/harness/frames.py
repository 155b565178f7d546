"""A frame as the planner's facade takes it, and its flattened form."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Frame(NamedTuple):
    cones: list  # five per-type (k, 2) arrays: unknown, right, left, 2 empty
    position: np.ndarray  # (2,)
    direction: np.ndarray  # (2,)


def flatten(cones: list, n_max: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-type cone lists -> padded (n_max, 3) [x, y, colour] and mask,
    types in order, as the planner's facade flattens them."""
    rows = [np.concatenate([np.asarray(c, np.float64).reshape(-1, 2),
                            np.full((len(c), 1), float(t))], axis=1)
            for t, c in enumerate(cones) if len(c)]
    flat = np.concatenate(rows) if rows else np.zeros((0, 3))
    if len(flat) > n_max:
        raise ValueError(f"{len(flat)} cones exceed the budget of {n_max}")
    out = np.zeros((n_max, 3), np.float32)
    out[:, 2] = -1.0
    out[: len(flat)] = flat
    mask = np.zeros(n_max, bool)
    mask[: len(flat)] = True
    return out, mask
