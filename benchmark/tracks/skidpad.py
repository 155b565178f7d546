"""The FSG skidpad and a car driving it, made from a seed on the host.

Frozen copies of the program's generators: the known skidpad path
(`assets/known_paths.py::generate_skidpad_path`: the entry straight, two
clockwise laps of the right circle, two counter-clockwise laps of the left,
the exit straight, 0.05 m apart) and the session (`skidpad_session`). The
cones follow the FS Rules' layout: 16 cones on each inner circle (radius
7.625 m), 13 on each outer one (radius 10.625 m: the 16 places beside the
inner cones, less the three inside the other circle), lane cones on the
straights, 0.02 m of noise from the seed. (The program's
`parallel/scenarios.py::skidpad_cones_known_frame` keeps 12 outer cones, by
a cut 1 mm from one of them.) The car drives
the known path, every 10th point (0.5 m) from point 100 on, heading along
it; all cones are of unknown colour and the map frame is the known frame
rotated by 0.3 rad and shifted by (4, -2.5) m.
"""

from __future__ import annotations

import numpy as np

from harness.frames import Frame

_SPACING = 0.05
_LAPS = (  # (cx, cy, r) in driving order: right x2 (clockwise), left x2
    (0.0548, -9.1410, 9.1217),
    (0.0550, -9.1418, 9.1211),
    (0.0550, 9.1223, 9.1231),
    (0.0553, 9.1217, 9.1235),
)
_ENTRY_LINE = (0.000384, 0.005219)
_EXIT_LINE = (0.000237, -0.006246)


def _rot(points: np.ndarray, theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.stack([c * points[..., 0] - s * points[..., 1], s * points[..., 0] + c * points[..., 1]], axis=-1)


def known_path() -> np.ndarray:
    rng = np.random.default_rng(7)
    entry_x = np.arange(-20.0, 0.0, _SPACING)
    parts = [np.stack([entry_x, _ENTRY_LINE[0] * entry_x + _ENTRY_LINE[1]], axis=1)]
    for i, (cx, cy, r) in enumerate(_LAPS):
        a0 = np.arctan2(-cy, -cx)
        sweep = -2 * np.pi if i < 2 else 2 * np.pi
        n = int(round(abs(sweep) * r / _SPACING))
        ang = np.linspace(a0, a0 + sweep, n, endpoint=False)
        parts.append(np.array([cx, cy]) + r * np.stack([np.cos(ang), np.sin(ang)], axis=1))
    exit_x = np.arange(0.0, 40.0, _SPACING)
    parts.append(np.stack([exit_x, _EXIT_LINE[0] * exit_x + _EXIT_LINE[1]], axis=1))
    path = np.concatenate(parts)
    seg = np.linalg.norm(np.diff(path, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    su = np.arange(0.0, s[-1], _SPACING)
    path = np.stack([np.interp(su, s, path[:, 0]), np.interp(su, s, path[:, 1])], axis=1)
    return (path + rng.normal(0.0, 1e-3, path.shape)).astype(np.float64)


def cones_known_frame(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = [np.array(_LAPS[0][:2]).round(3), np.array(_LAPS[2][:2]).round(3)]
    ang = np.linspace(0.0, 2 * np.pi, 16, endpoint=False)
    unit = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    rows = []
    for center, other in (centers, centers[::-1]):
        rows.append(center + 7.625 * unit)
        # the three places nearest the other circle lie 7.6 and 9.4 m from
        # its centre, within its outer circle; the rest 13.1 m or more
        outer = center + 10.625 * unit
        rows.append(outer[np.linalg.norm(outer - other, axis=1) > 10.625])
    lane_x = np.concatenate([np.arange(-18.0, -11.0, 3.0), np.arange(12.0, 25.0, 3.0)])
    for y in (1.5, -1.5):
        rows.append(np.stack([lane_x, np.full_like(lane_x, y)], axis=1))
    cones = np.concatenate(rows)
    return cones + rng.normal(0.0, 0.02, cones.shape)


class Drive:
    """One skidpad run after another, the same frames each run."""

    def __init__(self, config: dict, traffic: dict, seed: int, lane: int | None = None):
        layout = config["track"]
        self.rotation = float(layout["map_rotation_rad"])
        self.shift = np.asarray(layout["map_shift_m"], np.float64)
        self.path = known_path()
        stride = traffic["skidpad"]["stride"]
        self.poses = np.arange(layout["first_pose"], len(self.path) - stride, stride)
        self.frames_per_run = len(self.poses)
        self.stride = stride
        self.cones_map = self.to_map(cones_known_frame(seed))
        #: the reference's relocalization of each run: run start -> (transform
        #: or None, first frame after the one it relocalized on or was tried to)
        self.relocalized: dict = {}

    def to_map(self, points: np.ndarray) -> np.ndarray:
        return _rot(points, self.rotation) + self.shift

    def known_pose(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        k = self.poses[i % self.frames_per_run]
        heading = self.path[k + self.stride] - self.path[k]
        return self.path[k], heading / np.linalg.norm(heading)

    def frame(self, i: int) -> tuple[Frame, None, None]:
        pos, heading = self.known_pose(i)
        empty = np.zeros((0, 2))
        frame = Frame(
            cones=[self.cones_map, empty, empty, empty, empty],
            position=self.to_map(pos),
            direction=_rot(heading, self.rotation),
        )
        return frame, None, None

    def start(self, rng: np.random.Generator) -> int:
        return 0  # every run starts at the entry



def reference(drive: Drive, i: int):
    """The reference's (40, 4) path of frame ``i`` in the map frame (None:
    it would not give one).

    The run's frames are relocalized from its first on, until one
    relocalizes; from there the car's pose goes to the known frame, the
    known path is tracked frame by frame, and the path comes back to the
    map frame through the same transform."""
    from reference.planner import skidpad_path
    from reference.relocalization import Transform, relocalize

    run_start = i - i % drive.frames_per_run
    transform, k = drive.relocalized.get(run_start, (None, run_start))
    first = drive.frame(run_start)[0]
    while transform is None and k <= i:
        frame = drive.frame(k)[0]
        found = relocalize(frame.cones[0], frame.position, first.position, first.direction, drive.path)
        k += 1
        if found is not None:
            transform = Transform(*found)
    drive.relocalized[run_start] = (transform, k)
    if transform is None:
        return None
    poses = []
    for j in range(k - 1, i + 1):
        frame = drive.frame(j)[0]
        heading = frame.direction / np.linalg.norm(frame.direction)
        poses.append((transform.to_known(frame.position), _rot(heading, transform.rotation)))
    path = skidpad_path(drive.path[::2], poses)
    if path is None:
        return None
    out = path.copy()
    out[:, 1:3] = transform.to_map(path[:, 1:3])
    return out
