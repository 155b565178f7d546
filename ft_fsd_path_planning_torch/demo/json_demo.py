"""CLI replay demo — the reference `python -m fsd_path_planning.demo`
equivalent (demo/json_demo.py): replays a recorded session JSON through the
planner, reports per-frame timing, optionally saves an animation.

Usage:
    python -m ft_fsd_path_planning_torch.demo DATA.json [--mission skidpad]
        [--remove-color-info] [--output-path anim.mp4] [--max-frames N]
        [--dark] [--timing-histogram hist.png] [--device cuda|cpu]

Counterpart of `ft_fsd_path_planning_tpu/demo/json_demo.py`. Runs on
``cuda`` unless ``--device cpu`` is given, and raises without a GPU. The
first-frame line counts the CUDA kernels' build (once per checkout) with the
first frame. Frames over 0.1 s are counted as outliers; the last line gives
the launches of the two CUDA kernels over the run (0 on the CPU, where
their plain versions run).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from ft_fsd_path_planning_torch import MissionTypes, PathPlanner
from ft_fsd_path_planning_torch.config import default_config
from ft_fsd_path_planning_torch.ops import banded_cholesky, beam_search
from ft_fsd_path_planning_torch.utils.cone_types import ConeTypes

OUTLIER_S = 0.1


def select_mission_by_filename(name: str) -> MissionTypes:
    """Reference json_demo.py:38-51."""
    lowered = name.lower()
    if "accel" in lowered:
        return MissionTypes.acceleration
    if "skidpad" in lowered:
        return MissionTypes.skidpad
    return MissionTypes.trackdrive


def load_data_json(data_path: Path, remove_color_info: bool = False):
    data = json.loads(data_path.read_text())
    positions = np.array([d["car_position"] for d in data])
    directions = np.array([d["car_direction"] for d in data])
    cone_observations = [
        [np.array(c).reshape(-1, 2) for c in d["slam_cones"]] for d in data
    ]
    if remove_color_info:
        stripped = []
        for cones in cone_observations:
            new_obs = [np.zeros((0, 2)) for _ in range(5)]
            if any(len(c) for c in cones):
                new_obs[ConeTypes.UNKNOWN] = np.vstack(
                    [c.reshape(-1, 2) for c in cones]
                )
            stripped.append(new_obs)
        cone_observations = stripped
    return positions, directions, cone_observations


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data_path", type=Path)
    parser.add_argument("--mission", type=str, default=None)
    parser.add_argument("--remove-color-info", action="store_true")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--output-path", type=Path, default=None)
    parser.add_argument(
        "--dark", action="store_true",
        help="dark-background animation (reference json_demo.py:139-154)",
    )
    parser.add_argument(
        "--timing-histogram", type=Path, default=None,
        help="save a per-frame runtime histogram PNG (reference :134-136)",
    )
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    mission = (
        MissionTypes[args.mission]
        if args.mission
        else select_mission_by_filename(args.data_path.name)
    )
    print(f"mission: {mission.name}")

    positions, directions, cone_observations = load_data_json(
        args.data_path, remove_color_info=args.remove_color_info
    )
    if args.max_frames:
        positions = positions[: args.max_frames]
        directions = directions[: args.max_frames]
        cone_observations = cone_observations[: args.max_frames]

    # auto-size the cone shape budget: whole-SLAM-map sessions (e.g. the
    # shipped closed-track session) carry >128 cones per frame
    max_cones = max(
        (sum(len(c) for c in cones) for cones in cone_observations), default=0
    )
    config = default_config(mission, n_cones=256) if max_cones > 128 else None
    planner = PathPlanner(mission, config=config, device=args.device)

    # warm-up (reference json_demo.py:88-94): kernel build and first frame
    t0 = time.perf_counter()
    planner.calculate_path_in_global_frame(
        cone_observations[0], positions[0], directions[0]
    )
    print(f"kernel build + first frame: {time.perf_counter() - t0:.1f} s")

    banded_cholesky.reset_launch_count()
    beam_search.reset_launch_count()
    results = []
    sorted_overlays = []
    timings = []
    for cones, pos, direction in zip(cone_observations, positions, directions):
        t0 = time.perf_counter()
        out = planner.calculate_path_in_global_frame(
            cones, pos, direction, return_intermediate_results=True
        )
        timings.append(time.perf_counter() - t0)
        results.append(out[0])
        sorted_overlays.append((out[1], out[2]))  # sorted left / right

    timings_arr = np.array(timings[1:]) * 1000
    outliers = [i for i, dt in enumerate(timings) if dt > OUTLIER_S]
    print(f"frames over {OUTLIER_S * 1000:.0f} ms (outliers): {len(outliers)} of {len(timings)}")
    print(
        f"frames: {len(timings)}  mean: {timings_arr.mean():.2f} ms  "
        f"p50: {np.percentile(timings_arr, 50):.2f} ms  "
        f"p99: {np.percentile(timings_arr, 99):.2f} ms"
    )
    print(
        "kernel launches: "
        + json.dumps({"B1": banded_cholesky.launch_count, "B2": beam_search.launch_count})
    )

    if args.timing_histogram is not None:
        _save_histogram(args.timing_histogram, timings)

    if args.output_path is not None:
        _save_animation(
            args.output_path, results, positions, directions,
            cone_observations, sorted_overlays, dark=args.dark,
        )


def _save_histogram(path: Path, timings) -> None:
    """Per-frame runtime histogram, warmup frames skipped (reference
    json_demo.py:134-136)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping histogram")
        return
    fig, ax = plt.subplots()
    ax.hist(np.array(timings[10:]) * 1000, bins=30)
    ax.set_xlabel("ms / frame")
    ax.set_ylabel("frames")
    fig.savefig(path)
    print(f"saved {path}")


def _save_animation(
    path: Path, results, positions, directions, cone_observations,
    sorted_overlays, dark: bool = False,
) -> None:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.animation import ArtistAnimation
    except ImportError:
        print("matplotlib unavailable; skipping animation")
        return

    # reference color scheme incl. dark mode (json_demo.py:138-169)
    plt.style.use("dark_background" if dark else "default")
    unknown_color = "w" if dark else "k"

    fig, ax = plt.subplots(figsize=(8, 8))
    artists = []
    for out, pos, direction, cones, (sl, sr) in zip(
        results, positions, directions, cone_observations, sorted_overlays
    ):
        frame_artists = []
        for cone_type, style in (
            (ConeTypes.LEFT, "bo"),
            (ConeTypes.RIGHT, "yo"),
            (ConeTypes.UNKNOWN, unknown_color + "o"),
            (ConeTypes.ORANGE_SMALL, "o"),
            (ConeTypes.ORANGE_BIG, "o"),
        ):
            pts = cones[cone_type]
            if len(pts):
                kw = {}
                if cone_type == ConeTypes.ORANGE_SMALL:
                    kw["color"] = "orange"
                elif cone_type == ConeTypes.ORANGE_BIG:
                    kw["color"] = "darkorange"
                frame_artists.extend(
                    ax.plot(pts[:, 0], pts[:, 1], style, markersize=4, **kw)
                )
        # sorted-cone overlays (reference draws the sorted traces as lines)
        if len(sl):
            frame_artists.extend(ax.plot(sl[:, 0], sl[:, 1], "b-", linewidth=1))
        if len(sr):
            frame_artists.extend(ax.plot(sr[:, 0], sr[:, 1], "y-", linewidth=1))
        frame_artists.extend(ax.plot(out[:, 1], out[:, 2], "r-"))
        frame_artists.extend(ax.plot([pos[0]], [pos[1]], "go"))
        frame_artists.extend(
            ax.plot(
                [pos[0], pos[0] + direction[0] * 3],
                [pos[1], pos[1] + direction[1] * 3],
                "g-",
            )
        )
        artists.append(frame_artists)
    ax.set_aspect("equal")
    anim = ArtistAnimation(fig, artists, interval=100, blit=True, repeat_delay=1000)
    anim.save(str(path), fps=10)
    print(f"saved {path}")


if __name__ == "__main__":
    main()
