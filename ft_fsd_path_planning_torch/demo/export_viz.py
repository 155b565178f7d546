"""Export pipeline runs as `viz_data.js` for the interactive HTML viewer.

The reference ships a streamlit app for interactively exploring the pipeline
on curated scenarios (streamlit_main.py, demo/streamlit_demo/*). This
exporter delivers that dependency-free: it runs every stress fixture
(demo/scenarios.py) plus a slice of the committed closed-track session
through the planner with intermediate results, and writes a `viz_data.js`
payload that `interactive.html` (vanilla JS + canvas, no network, opens from
file://) renders with a frame slider, stage toggles, and dark mode.
Counterpart of `ft_fsd_path_planning_tpu/demo/export_viz.py`.

Usage:
    python -m ft_fsd_path_planning_torch.demo.export_viz [--out DIR]
        [--max-session-frames N] [--device cuda|cpu]
    # then open DIR/interactive.html in any browser (default DIR: build/viz)
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import numpy as np

from ft_fsd_path_planning_torch import MissionTypes, PathPlanner
from ft_fsd_path_planning_torch.config import default_config
from ft_fsd_path_planning_torch.demo.make_session import ROOT, SESSION_PATH
from ft_fsd_path_planning_torch.demo.scenarios import ALL_SCENARIOS
from ft_fsd_path_planning_torch.device import resolve_device
from ft_fsd_path_planning_torch.utils.cone_types import ConeTypes

SESSION_STRIDE = 6  # 50 of the 300 session frames


def _round(arr, nd=3):
    return np.round(np.asarray(arr, float), nd).tolist()


def _frame_payload(planner, cones, pos, direction) -> dict:
    (path, sorted_l, sorted_r, left_v, right_v, l2r, r2l) = (
        planner.calculate_path_in_global_frame(
            [np.asarray(c, float).reshape(-1, 2) for c in cones],
            np.asarray(pos, float),
            np.asarray(direction, float),
            return_intermediate_results=True,
        )
    )
    return {
        "pos": _round(pos),
        "dir": _round(direction),
        "cones": {
            "unknown": _round(np.asarray(cones[ConeTypes.UNKNOWN]).reshape(-1, 2)),
            "right": _round(np.asarray(cones[ConeTypes.RIGHT]).reshape(-1, 2)),
            "left": _round(np.asarray(cones[ConeTypes.LEFT]).reshape(-1, 2)),
        },
        "sorted_left": _round(sorted_l),
        "sorted_right": _round(sorted_r),
        "left_v": _round(left_v),
        "right_v": _round(right_v),
        "path": _round(path[:, 1:3]),
        "curv": _round(path[:, 3], 4),
    }


def build_payload(max_session_frames: int | None = None, device=None) -> dict:
    """Every fixture through one trackdrive planner (n_cones = 128), then
    every ``SESSION_STRIDE``-th session frame (the first
    ``max_session_frames`` of them) through one at n_cones = 256, on
    ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    data: dict = {"scenarios": {}, "session": []}

    planner_small = PathPlanner(MissionTypes.trackdrive, device=dev)
    for name, fn in sorted(ALL_SCENARIOS.items()):
        cones, pos, direction = fn()
        data["scenarios"][name] = _frame_payload(planner_small, cones, pos, direction)

    frames = json.loads(SESSION_PATH.read_text())[::SESSION_STRIDE]
    if max_session_frames:
        frames = frames[:max_session_frames]
    planner_big = PathPlanner(
        MissionTypes.trackdrive,
        config=default_config(MissionTypes.trackdrive, n_cones=256),
        device=dev,
    )
    for fr in frames:
        data["session"].append(
            _frame_payload(
                planner_big, fr["slam_cones"], fr["car_position"], fr["car_direction"]
            )
        )
    return data


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "viz")
    parser.add_argument("--max-session-frames", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    payload = build_payload(args.max_session_frames, args.device)
    args.out.mkdir(parents=True, exist_ok=True)
    js = "window.VIZ_DATA = " + json.dumps(payload, separators=(",", ":")) + ";\n"
    (args.out / "viz_data.js").write_text(js)
    shutil.copy(Path(__file__).parent / "interactive.html", args.out / "interactive.html")
    size_kb = (args.out / "viz_data.js").stat().st_size / 1024
    print(f"wrote {args.out}/viz_data.js ({size_kb:.0f} KiB) and interactive.html")
    print(f"open {args.out}/interactive.html in a browser")


if __name__ == "__main__":
    main()
