"""Track layouts and their frames, made from a seed on the host.

Frozen copies of the program's generators, so that a change to the program
cannot change the traffic it is measured on: the closed track is
`parallel/scenarios.py::closed_track_scenario`, and the frames follow the
committed two-lap session's generator (`demo/make_session.py`): the car
stands on centerline sample ``(i * n) // frames_per_lap`` in frame ``i``,
heading along the track, and every cone of the whole map carries a fresh
Gaussian SLAM jitter, rounded to 0.1 mm.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from harness.frames import Frame

CLEAR_M = 7.0  # least distance of a distractor from any border cone


class ClosedTrack(NamedTuple):
    left: np.ndarray  # (n, 2) blue cones, numbered along the driving direction
    right: np.ndarray  # (n, 2) yellow cones, cone k opposite left cone k
    unknown: np.ndarray  # (u, 2) off-track distractors of unknown colour
    centerline: np.ndarray  # (n, 2)
    tangent: np.ndarray  # (n, 2) unit driving direction


def closed_track(
    seed: int,
    base_radius: float = 36.0,
    half_width: float = 1.5,
    spacing: float = 3.5,
    n_unknown: int = 6,
) -> ClosedTrack:
    """A smooth random closed loop, cones on both borders ``spacing`` apart,
    and a few UNKNOWN distractors off the track.

    The program's generator puts its distractors 4-8 m from a centerline
    point along the normal of another, random station, so they can stand on
    the track or beside a border, where the sorter rightly takes them into
    a border. This copy keeps them ``CLEAR_M`` or more from every border
    cone, beyond the sorter's neighbour distance (6.5 m), so that they sit
    in the map, and in every search's candidate set, while the border cones
    alone are the right answer."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(0.0, 2 * np.pi, 4096, endpoint=False)
    r = np.full_like(theta, base_radius)
    for k in (2, 3, 4):
        amp = base_radius * rng.uniform(0.03, 0.10)
        r = r + amp * np.cos(k * theta + rng.uniform(0, 2 * np.pi))
    center = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)

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

    left = cl + normal * half_width
    right = cl - normal * half_width
    # off the track: 8-14 m from the centerline across the track at their own
    # station, either side, and no nearer than CLEAR_M to any border cone
    borders = np.concatenate([left, right])
    unknown = np.zeros((0, 2))
    while len(unknown) < n_unknown:
        at = rng.integers(0, n_samples)
        side = rng.choice([-1.0, 1.0])
        p = cl[at] + normal[at] * side * rng.uniform(8.0, 14.0) + tangent[at] * rng.normal(0, 1.0)
        if np.min(np.linalg.norm(borders - p, axis=1)) >= CLEAR_M:
            unknown = np.concatenate([unknown, p[None]])
    return ClosedTrack(left, right, unknown, cl, tangent)


def track_from_config(layout: dict, seed: int) -> ClosedTrack:
    return closed_track(
        seed,
        base_radius=layout["base_radius_m"],
        half_width=layout["half_width_m"],
        spacing=layout["cone_spacing_m"],
        n_unknown=layout["n_unknown"],
    )


def closed_track_frame(
    track: ClosedTrack, i: int, frames_per_lap: int, jitter_m: float, jitter_seed
) -> tuple[Frame, np.ndarray, np.ndarray]:
    """Frame ``i`` of a drive around ``track``: (frame, left, right), the
    last two being the jittered borders in track order."""
    n = len(track.centerline)
    j = (i * n) // frames_per_lap % n
    rng = np.random.default_rng(jitter_seed)

    def jitter(arr: np.ndarray) -> np.ndarray:
        return np.round(arr + rng.normal(0.0, jitter_m, arr.shape), 4)

    unknown, right, left = jitter(track.unknown), jitter(track.right), jitter(track.left)
    empty = np.zeros((0, 2))
    frame = Frame(
        cones=[unknown, right, left, empty, empty],
        position=np.round(track.centerline[j], 4),
        direction=np.round(track.tangent[j], 4),
    )
    return frame, left, right


class Drive:
    """One car's drive around a closed track: frame ``i`` on demand, made
    from (seed, lane, i) alone, so the check can make it again."""

    def __init__(self, config: dict, traffic: dict, seed: int, lane: int | None = None):
        layout = config["track"]
        params = traffic["closed_track"]
        if lane is None:
            layout_seed = layout["layout_seed"]
        else:  # a sweep: every lane its own layout, drawn from the run's seed
            layout_seed = int(np.random.SeedSequence([seed, lane]).generate_state(1)[0])
        self.track = track_from_config(layout, layout_seed)
        self.seed, self.lane = seed, -1 if lane is None else lane
        self.frames_per_lap = params["frames_per_lap"]
        self.jitter_m = params["jitter_m"]

    def frame(self, i: int) -> tuple[Frame, np.ndarray, np.ndarray]:
        return closed_track_frame(
            self.track, i, self.frames_per_lap, self.jitter_m,
            [self.seed, self.lane + 1, i % self.frames_per_lap],
        )

    def start(self, rng: np.random.Generator) -> int:
        """A station to start the drive at."""
        return int(rng.integers(self.frames_per_lap))


def reference(drive: Drive, i: int):
    """The reference's (40, 4) path of frame ``i`` (None: it would fall
    back to the previous path)."""
    from reference.planner import trackdrive_path

    frame, left, right = drive.frame(i)
    return trackdrive_path(left, right, frame.position, frame.direction)
