"""The self-contained closed-track session and its ground truth.

Counterpart of `ft_fsd_path_planning_tpu/demo/make_session.py`. The
committed session (`ft_fsd_path_planning_tpu/demo/closed_track_session.json`,
reference schema: a list of frames with car_position, car_direction and
slam_cones = 5 per-type cone lists) is a smooth random closed loop
(`parallel/scenarios.py::closed_track_scenario`), the car driving
``N_LAPS`` laps with the whole SLAM map visible every frame and per-frame
observation noise. :func:`generate_session` gives that file's frames again
from the same seed, and :func:`ground_truth` the track's centerline, which
the replay bench scores deviation against.

    python -m ft_fsd_path_planning_torch.demo.make_session [--out PATH]

writes the frames to ``PATH`` (default ``build/closed_track_session.json``);
the committed file is only read.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ft_fsd_path_planning_torch.parallel.scenarios import closed_track_scenario

SEED = 3
N_LAPS = 2
FRAMES_PER_LAP = 150
OBS_NOISE = 0.02  # per-frame SLAM jitter (m)
ROOT = Path(__file__).resolve().parents[2]
SESSION_PATH = ROOT / "ft_fsd_path_planning_tpu" / "demo" / "closed_track_session.json"
GOLDEN_PATH = SESSION_PATH.parent / "trackdrive_golden.npz"


def ground_truth():
    """(left, right, unknown, centerline, tangents) of the session track."""
    return closed_track_scenario(seed=SEED)


def generate_session() -> list[dict]:
    left, right, unknown, cl, tangent = ground_truth()
    rng = np.random.default_rng(SEED + 1)
    n = len(cl)
    frames = []
    total = N_LAPS * FRAMES_PER_LAP
    for i in range(total):
        j = (i * n * N_LAPS) // total % n

        def jitter(arr):
            return np.round(arr + rng.normal(0.0, OBS_NOISE, arr.shape), 4)

        frames.append(
            {
                "car_position": np.round(cl[j], 4).tolist(),
                "car_direction": np.round(tangent[j], 4).tolist(),
                "slam_cones": [
                    jitter(unknown).tolist(),
                    jitter(right).tolist(),  # ConeTypes.RIGHT = 1
                    jitter(left).tolist(),  # ConeTypes.LEFT = 2
                    [],
                    [],
                ],
            }
        )
    return frames


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "closed_track_session.json")
    args = parser.parse_args(argv)
    frames = generate_session()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(frames, separators=(",", ":")))
    size_kb = args.out.stat().st_size / 1024
    print(f"wrote {args.out} ({len(frames)} frames, {size_kb:.0f} KiB)")


if __name__ == "__main__":
    main()
