"""Synthetic scenario generation: perturbed corridors as frame batches.

Counterpart of `ft_fsd_path_planning_tpu/parallel/scenarios.py`: the same
numpy generators (same seeds give the same frames), returning torch tensors
on the requested device. Beside them, seeded sessions of the relocalizer
missions and of trackdrive with a global path (numpy only): a skidpad track
in a rotated and shifted map frame with the car driving the known path, an
acceleration corridor, and batches of single frames each under its own
SE(2).
"""

from __future__ import annotations

import numpy as np
import torch

from ft_fsd_path_planning_torch.assets.known_paths import _LAPS, BASE_SKIDPAD_PATH
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


def closed_track_scenario(
    seed: int = 0,
    base_radius: float = 36.0,
    half_width: float = 1.5,
    spacing: float = 3.5,
    n_unknown: int = 6,
):
    """A closed FSG-autocross-like map: a smooth random loop with cones on
    both borders plus a few off-track UNKNOWN distractors.

    This is the workload the reference actually runs on: it flattens the
    WHOLE SLAM map every frame, so a realistic frame carries 150-250 cones,
    most of them far from the car. Returns ``(left, right, unknown,
    centerline, tangents)`` with the centerline sampled uniformly in arc
    length (car poses for replay come from it).
    """
    rng = np.random.default_rng(seed)

    # radial harmonics: smooth, closed, no self-intersection for small amps
    theta = np.linspace(0.0, 2 * np.pi, 4096, endpoint=False)
    r = np.full_like(theta, base_radius)
    for k in (2, 3, 4):
        amp = base_radius * rng.uniform(0.03, 0.10)
        r = r + amp * np.cos(k * theta + rng.uniform(0, 2 * np.pi))
    center = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)

    # resample uniformly in arc length
    seg = np.linalg.norm(np.diff(center, axis=0, append=center[:1]), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])[:-1]
    total = s[-1] + seg[-1]
    n_samples = int(total / spacing)
    su = np.arange(n_samples) * (total / n_samples)
    cx = np.interp(su, s, center[:, 0], period=total)
    cy = np.interp(su, s, center[:, 1], period=total)
    cl = np.stack([cx, cy], axis=1)

    tangent = np.roll(cl, -1, axis=0) - np.roll(cl, 1, axis=0)
    tangent /= np.linalg.norm(tangent, axis=1, keepdims=True)
    normal = np.stack([-tangent[:, 1], tangent[:, 0]], axis=1)

    # counter-clockwise loop: inner border is LEFT (blue), outer is RIGHT
    left = cl + normal * half_width
    right = cl - normal * half_width
    unknown = (
        cl[rng.integers(0, n_samples, n_unknown)]
        + rng.normal(0, 1.0, (n_unknown, 2))
        + normal[rng.integers(0, n_samples, n_unknown)] * rng.uniform(
            4.0, 8.0, (n_unknown, 1)
        )
    )
    return left, right, unknown, cl, tangent


def _cone_lists(unknown=None, left=None, right=None) -> list[np.ndarray]:
    cones = [np.zeros((0, 2)) for _ in range(5)]
    for cone_type, arr in ((ConeTypes.UNKNOWN, unknown), (ConeTypes.LEFT, left), (ConeTypes.RIGHT, right)):
        if arr is not None:
            cones[cone_type] = arr
    return cones


def closed_track_frames(seed: int = 0, n_frames: int = 8, **kwargs):
    """Whole-map frames with the car stepping along the closed track."""
    left, right, unknown, cl, tangent = closed_track_scenario(seed, **kwargs)
    n = len(cl)
    frames = []
    for i in range(n_frames):
        j = (i * n) // n_frames
        frames.append((_cone_lists(unknown, left, right), cl[j].copy(), tangent[j].copy()))
    return frames


# ---------------------------------------------------------------------------
# mission sessions: (cones by type, position, direction) per frame, float64
# ---------------------------------------------------------------------------

SKIDPAD_MAP_ROTATION = 0.3  # the map frame is the known frame rotated by this, rad
SKIDPAD_MAP_SHIFT = (4.0, -2.5)  # and then shifted by this, m


def _rot(points: np.ndarray, theta) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.stack([c * points[..., 0] - s * points[..., 1], s * points[..., 0] + c * points[..., 1]], axis=-1)


def skidpad_cones_known_frame(seed: int = 0) -> np.ndarray:
    """The cones of a skidpad track in the known path's frame, (72, 2): two
    inner rings of 16 cones (radius 7.625 m) about the two lap centres, two
    outer rings of 16 (radius 10.625 m, offset by half a cone spacing)
    without the cones that would stand inside the other circle's lane, and
    lane cones 1.5 m to either side of the entry and exit straights;
    Gaussian position noise of 0.02 m."""
    rng = np.random.default_rng(seed)
    centers = [np.array(_LAPS[0][:2]).round(3), np.array(_LAPS[2][:2]).round(3)]
    ang = np.linspace(0.0, 2 * np.pi, 16, endpoint=False)
    unit = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    unit_off = _rot(unit, np.pi / 16)
    rows = []
    for center, other in (centers, centers[::-1]):
        rows.append(center + 7.625 * unit)
        outer = center + 10.625 * unit_off
        rows.append(outer[np.linalg.norm(outer - other, axis=1) >= 11.125])
    lane_x = np.concatenate([np.arange(-18.0, -11.0, 3.0), np.arange(12.0, 25.0, 3.0)])
    for y in (1.5, -1.5):
        rows.append(np.stack([lane_x, np.full_like(lane_x, y)], axis=1))
    cones = np.concatenate(rows)
    return cones + rng.normal(0.0, 0.02, cones.shape)


def _known_to_map(points: np.ndarray, rotation: float, shift) -> np.ndarray:
    return _rot(points, rotation) + np.asarray(shift, np.float64)


def skidpad_session(partial_view: bool = False, n_frames: int | None = None, seed: int = 0):
    """The car drives the known skidpad path (every 10th point from index
    100, 0.5 m a frame, heading along the path) through all four laps, in a
    map frame rotated and shifted against the known frame; every cone is of
    unknown colour. With ``partial_view`` only the cones within 10 m of the
    car are passed, so that early frames cannot relocalize and retry. A list
    of (cones by type, position (2,), direction (2,))."""
    cones_known = skidpad_cones_known_frame(seed)
    idx = np.arange(100, len(BASE_SKIDPAD_PATH) - 10, 10)[:n_frames]
    frames = []
    for i in idx:
        pos = BASE_SKIDPAD_PATH[i]
        heading = BASE_SKIDPAD_PATH[i + 10] - pos
        heading = heading / np.linalg.norm(heading)
        seen = cones_known
        if partial_view:
            seen = cones_known[np.linalg.norm(cones_known - pos, axis=1) < 10.0]
        frames.append((
            _cone_lists(unknown=_known_to_map(seen, SKIDPAD_MAP_ROTATION, SKIDPAD_MAP_SHIFT)),
            _known_to_map(pos, SKIDPAD_MAP_ROTATION, SKIDPAD_MAP_SHIFT),
            _rot(heading, SKIDPAD_MAP_ROTATION),
        ))
    return frames


def acceleration_session(n_frames: int = 60, seed: int = 0):
    """A straight corridor of cone rows like the acceleration track, the car
    advancing 1.5 m a frame along it."""
    rng = np.random.default_rng(seed)
    xs = np.arange(-5.0, 100.0, 4.0)
    left = np.stack([xs, np.full_like(xs, 1.6)], axis=1)
    right = np.stack([xs, np.full_like(xs, -1.6)], axis=1)
    left = left + rng.normal(0, 0.03, left.shape)
    right = right + rng.normal(0, 0.03, right.shape)
    return [
        (_cone_lists(left=left, right=right), np.array([t * 1.5, 0.0]), np.array([1.0, 0.0]))
        for t in range(n_frames)
    ]


def global_path_circle() -> np.ndarray:
    """A 30 m circle through the origin, 700 points, as a user-set global path."""
    ang = np.linspace(0, 2 * np.pi, 700, endpoint=False)
    return 30.0 * np.stack([np.sin(ang), 1 - np.cos(ang)], axis=1)


def corridor_session(n_frames: int = 8):
    """A straight coloured corridor (12 cones a side, 3 m wide), the car
    advancing 2 m a frame: the trackdrive frames the global path is set and
    unset over."""
    left, right = corridor_scenario(0.0, n_cones_side=12)
    return [
        (_cone_lists(left=left, right=right), np.array([t * 2.0, 0.0]), np.array([1.0, 0.0]))
        for t in range(n_frames)
    ]


PARTIAL_VIEW_FRAMES = 60


def mission_sessions(n_frames: int | None = None) -> dict[str, tuple[str, list]]:
    """name -> (mission name, frames): the seeded relocalizer-mission
    sessions, each cut to its first ``n_frames`` frames. The golden paths of
    `assets/missions_golden.npz` are the JAX package's on exactly these."""
    accel = acceleration_session()[:n_frames]
    return {
        "skidpad": ("skidpad", skidpad_session(n_frames=n_frames)),
        "skidpad_partial": ("skidpad", skidpad_session(True, PARTIAL_VIEW_FRAMES)[:n_frames]),
        "acceleration": ("acceleration", accel),
        "ebs_test": ("ebs_test", accel),
    }


def mission_frame_batch_numpy(
    cfg: PlannerConfig, batch: int, seed: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``batch`` single frames of ``cfg``'s relocalizer mission, each under
    its own SE(2) (rotation in +-pi, shift in +-10 m) so that every lane
    relocalizes on its own: skidpad poses drawn along the known path, or
    acceleration poses along the first 60 m of the corridor. Returns (cones
    (B, N, 3), mask (B, N), positions (B, 2), directions (B, 2), map
    rotations (B,)) as numpy arrays; the transform a lane should find has
    rotation ``-map rotation``."""
    rng = np.random.default_rng(seed)
    n = cfg.shapes.n_cones
    skidpad = cfg.mission.name == "skidpad"
    if skidpad:
        cones_known = skidpad_cones_known_frame(seed)
        color = float(ConeTypes.UNKNOWN)
        colors = np.full(len(cones_known), color)
    else:
        lists = acceleration_session(1, seed)[0][0]
        cones_known = np.concatenate([lists[ConeTypes.LEFT], lists[ConeTypes.RIGHT]])
        colors = np.concatenate([
            np.full(len(lists[ConeTypes.LEFT]), float(ConeTypes.LEFT)),
            np.full(len(lists[ConeTypes.RIGHT]), float(ConeTypes.RIGHT)),
        ])
    if len(cones_known) > n:
        raise ValueError(f"the mission's {len(cones_known)} cones exceed n_cones={n}")

    cones = np.zeros((batch, n, 3), np.float32)
    cones[:, :, 2] = -1.0
    mask = np.zeros((batch, n), bool)
    positions = np.zeros((batch, 2), np.float32)
    directions = np.zeros((batch, 2), np.float32)
    rotations = rng.uniform(-np.pi, np.pi, batch)
    shifts = rng.uniform(-10.0, 10.0, (batch, 2))
    for b in range(batch):
        if skidpad:
            i = int(rng.integers(100, len(BASE_SKIDPAD_PATH) - 10))
            pos = BASE_SKIDPAD_PATH[i]
            heading = BASE_SKIDPAD_PATH[i + 10] - pos
            heading = heading / np.linalg.norm(heading)
        else:
            pos, heading = np.array([rng.uniform(0.0, 60.0), 0.0]), np.array([1.0, 0.0])
        k = len(cones_known)
        cones[b, :k, :2] = _known_to_map(cones_known, rotations[b], shifts[b])
        cones[b, :k, 2] = colors
        mask[b, :k] = True
        positions[b] = _known_to_map(pos, rotations[b], shifts[b])
        directions[b] = _rot(heading, rotations[b])
    return cones, mask, positions, directions, rotations


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


def mission_frame_batch(
    cfg: PlannerConfig, batch: int, seed: int = 0, device: str | torch.device | None = None
) -> tuple[FrameInput, np.ndarray]:
    """(a (B, ...) FrameInput of `mission_frame_batch_numpy` frames on
    ``device``, the lanes' map rotations (B,) as numpy). Default ``cuda``;
    raises without a GPU unless ``device="cpu"``."""
    dev = resolve_device(device)
    *arrays, rotations = mission_frame_batch_numpy(cfg, batch, seed)
    return FrameInput(*(torch.as_tensor(a, device=dev) for a in arrays)), rotations
