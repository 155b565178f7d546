"""Synthetic scenario generation: perturbed corridors as frame batches.

Counterpart of `ft_fsd_path_planning_tpu/parallel/scenarios.py`: the same
numpy generators (same seeds give the same frames), returning torch tensors
on the requested device.
"""

from __future__ import annotations

import numpy as np
import torch

from ft_fsd_path_planning_torch.config import PlannerConfig
from ft_fsd_path_planning_torch.device import resolve_device
from ft_fsd_path_planning_torch.models.planner import FrameInput
from ft_fsd_path_planning_torch.utils.cone_types import ConeTypes


def corridor_scenario(
    curv: float, n_cones_side: int = 10, width: float = 3.0, spacing: float = 3.5
):
    """A cone corridor along an arc of the given curvature sign/strength."""
    s = np.arange(n_cones_side) * spacing
    if abs(curv) < 1e-9:
        center = np.stack([s, np.zeros(n_cones_side)], axis=1)
        normal = np.tile([[0.0, 1.0]], (n_cones_side, 1))
    else:
        radius = 30.0 / curv
        ang = s / radius
        center = radius * np.stack([np.sin(ang), 1 - np.cos(ang)], axis=1)
        normal = np.stack([-np.sin(ang), np.cos(ang)], axis=1)
    left = center + normal * width / 2
    right = center - normal * width / 2
    return left, right


def make_frame_batch_numpy(
    cfg: PlannerConfig,
    batch: int,
    seed: int = 0,
    noise: float = 0.05,
    dropout: float = 0.1,
    colorless: float = 0.2,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(cones (B, N, 3), mask (B, N), positions (B, 2), directions (B, 2))
    of perturbed corridor scenarios, as numpy arrays."""
    rng = np.random.default_rng(seed)
    n = cfg.shapes.n_cones

    cones = np.zeros((batch, n, 3), np.float32)
    cones[:, :, 2] = -1.0
    mask = np.zeros((batch, n), bool)
    positions = np.zeros((batch, 2), np.float32)
    directions = np.zeros((batch, 2), np.float32)

    for b in range(batch):
        curv = rng.uniform(-1.2, 1.2)
        left, right = corridor_scenario(curv, n_cones_side=int(rng.integers(7, 12)))
        left = left + rng.normal(0, noise, left.shape)
        right = right + rng.normal(0, noise, right.shape)
        keep_l = rng.random(len(left)) > dropout
        keep_r = rng.random(len(right)) > dropout
        left, right = left[keep_l], right[keep_r]

        strip_l = rng.random(len(left)) < colorless
        strip_r = rng.random(len(right)) < colorless

        rows = []
        for pts in (left[strip_l], right[strip_r]):
            for p in pts:
                rows.append((p[0], p[1], ConeTypes.UNKNOWN))
        for p in right[~strip_r]:
            rows.append((p[0], p[1], ConeTypes.RIGHT))
        for p in left[~strip_l]:
            rows.append((p[0], p[1], ConeTypes.LEFT))

        rows = rows[:n]
        cones[b, : len(rows)] = rows
        mask[b, : len(rows)] = True
        positions[b] = (0.0, 0.0)
        directions[b] = (1.0, 0.0)
    return cones, mask, positions, directions


def make_frame_batch(
    cfg: PlannerConfig,
    batch: int,
    seed: int = 0,
    noise: float = 0.05,
    dropout: float = 0.1,
    colorless: float = 0.2,
    device: str | torch.device | None = None,
) -> FrameInput:
    """A (B, ...) FrameInput of perturbed corridor scenarios on ``device``
    (default ``cuda``; raises without a GPU unless ``device="cpu"``)."""
    dev = resolve_device(device)
    arrays = make_frame_batch_numpy(cfg, batch, seed, noise, dropout, colorless)
    return FrameInput(*(torch.as_tensor(a, device=dev) for a in arrays))
