"""Live-parameter exploration server — the reference's interactive streamlit
pages without streamlit.

The reference lets a user pick curated scenarios, edit planner parameters,
and paste custom frame JSON, re-running the pipeline live
(`streamlit_main.py:83-88`, `demo/streamlit_demo/common.py:304-324`).
This module serves the same capability from the standard library: a
single-page app (vanilla JS + SVG) backed by a tiny HTTP endpoint that runs
the REAL planner on every request. Counterpart of
`ft_fsd_path_planning_tpu/demo/serve.py`.

Run:  python -m ft_fsd_path_planning_torch.demo.serve [--port 8008] [--device cuda|cpu]
Then open http://localhost:8008/ — pick a scenario or paste frame JSON
(reference schema: {car_position, car_direction, slam_cones}), tweak the
config fields, and Plan. The server keeps one planner per config, with its
state carried from request to request; the first plan of a config starts
that planner (on the card the first plan of all also builds the kernels).
On the card a config whose sorting shape kernel B2 does not take (say beam
width 10) is answered 400 and starts no planner.

Endpoints:
  GET  /            the explorer page
  GET  /scenarios   curated fixture list (demo/scenarios.py)
  POST /plan        {"config": {...}, "frames": [frame, ...]} ->
                    {"paths": [[...]], "intermediates": {...}, "timing_ms": ...}
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from ft_fsd_path_planning_torch import MissionTypes, PathPlanner
from ft_fsd_path_planning_torch.config import (
    PathConfig,
    PlannerConfig,
    SortingConfig,
    default_config,
)
from ft_fsd_path_planning_torch.demo import scenarios
from ft_fsd_path_planning_torch.device import resolve_device
from ft_fsd_path_planning_torch.ops.beam_search import UnsupportedShape

SCENARIOS = {
    "straight": scenarios.straight,
    "simple_corner": scenarios.simple_corner,
    "corner_missing_blue": scenarios.corner_missing_blue,
    "corner_missing_yellow": scenarios.corner_missing_yellow,
    "hairpin": scenarios.hairpin,
    "hairpin_extreme": scenarios.hairpin_extreme,
    "colorless_straight": scenarios.colorless_straight,
    "noisy_corner": scenarios.noisy_corner,
}

# editable knobs -> where they live in the config tree
_KNOBS = {
    "mission": ("trackdrive", "mission preset (trackdrive/skidpad/acceleration)"),
    "n_cones": (128, "cone shape budget (a new budget starts a new planner)"),
    "beam_width": (32, "beam K replacing the reference's exhaustive DFS"),
    "max_length": (12, "max cones per sorted side config"),
    "max_dist": (6.5, "adjacency edge cutoff [m]"),
    "threshold_directional_angle_deg": (40.0, "directional angle gate [deg]"),
    "threshold_absolute_angle_deg": (65.0, "absolute angle gate [deg]"),
    "smoothing": (0.2, "FITPACK smoothing s for the centerline fit"),
    "mpc_path_length": (20.0, "MPC horizon length [m]"),
    "experimental_performance_improvements": (False, "sorting-result cache"),
}

_PAGE = Path(__file__).parent / "explore.html"


def _build_config(overrides: dict) -> PlannerConfig:
    mission = MissionTypes[overrides.get("mission", "trackdrive")]
    sorting = SortingConfig(
        beam_width=int(overrides.get("beam_width", 32)),
        max_length=int(overrides.get("max_length", 12)),
        max_dist=float(overrides.get("max_dist", 6.5)),
        threshold_directional_angle=math.radians(
            float(overrides.get("threshold_directional_angle_deg", 40.0))
        ),
        threshold_absolute_angle=math.radians(
            float(overrides.get("threshold_absolute_angle_deg", 65.0))
        ),
    )
    path = PathConfig(
        smoothing=float(overrides.get("smoothing", 0.2)),
        mpc_path_length=float(overrides.get("mpc_path_length", 20.0)),
    )
    # config_len must track max_length (side configs hold max_length cones)
    config_len = int(overrides.get("max_length", 12))
    cfg = default_config(
        mission,
        experimental_performance_improvements=bool(
            overrides.get("experimental_performance_improvements", False)
        ),
        n_cones=int(overrides.get("n_cones", 128)),
        sorting=sorting,
        path=path,
    )
    if cfg.shapes.config_len != config_len:
        cfg = dataclasses.replace(
            cfg, shapes=dataclasses.replace(cfg.shapes, config_len=config_len)
        )
    return cfg


def _plan(payload: dict, planners: dict, device: torch.device) -> dict:
    """Run the payload's frames through the planner of its config (made on
    first use and kept in ``planners``, keyed by config and device: planners
    are stateful, a stateful mission needs its own state)."""
    cfg = _build_config(payload.get("config", {}))
    key = (cfg, device)
    planner = planners.get(key)
    if planner is None:
        planner = PathPlanner(cfg.mission, config=cfg, device=device)
        planners[key] = planner

    frames = payload.get("frames", [])
    out_paths, inter = [], []
    t0 = time.perf_counter()
    for frame in frames:
        cones = [np.array(c, float).reshape(-1, 2) for c in frame["slam_cones"]]
        res = planner.calculate_path_in_global_frame(
            cones,
            np.array(frame["car_position"], float),
            np.array(frame["car_direction"], float),
            return_intermediate_results=True,
        )
        path, sl, sr, lv, rv, _, _ = res
        out_paths.append(np.round(path, 4).tolist())
        inter.append(
            {
                "sorted_left": np.round(sl, 3).tolist(),
                "sorted_right": np.round(sr, 3).tolist(),
                "left_with_virtual": np.round(lv, 3).tolist(),
                "right_with_virtual": np.round(rv, 3).tolist(),
            }
        )
    dt = (time.perf_counter() - t0) * 1e3
    return {"paths": out_paths, "intermediates": inter, "timing_ms": round(dt, 1)}


def _scenario_payload() -> dict:
    out = {}
    for name, fn in SCENARIOS.items():
        cones, pos, direction = fn()
        out[name] = {
            "car_position": np.asarray(pos, float).tolist(),
            "car_direction": np.asarray(direction, float).tolist(),
            "slam_cones": [np.asarray(c, float).tolist() for c in cones],
        }
    return out


class PlanServer(ThreadingHTTPServer):
    """The explorer's HTTP server. It owns the planners, one per config, on
    one ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"``), and the lock that serialises the requests' planning:
    a planner carries state from frame to frame, and the handler threads
    share them."""

    def __init__(self, address: tuple[str, int], device: str | torch.device | None = None) -> None:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # an explicit index: handler threads never rely on a current device
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.planners: dict = {}
        self.plan_lock = threading.Lock()
        self.page = _PAGE.read_bytes()
        super().__init__(address, _Handler)


class _Handler(BaseHTTPRequestHandler):
    server: PlanServer

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        if self.path in ("/", "/index.html"):
            self._send(200, self.server.page, "text/html; charset=utf-8")
        elif self.path == "/scenarios":
            body = json.dumps(
                {"scenarios": _scenario_payload(), "knobs": _KNOBS}
            ).encode()
            self._send(200, body, "application/json")
        else:
            self._send(404, b"not found", "text/plain")

    def do_POST(self):  # noqa: N802
        if self.path != "/plan":
            self._send(404, b"not found", "text/plain")
            return
        try:
            n = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(n))
            with self.server.plan_lock:  # planners are stateful
                result = _plan(payload, self.server.planners, self.server.device)
            self._send(200, json.dumps(result).encode(), "application/json")
        except UnsupportedShape as e:  # a config the server's device does not run
            self._send(400, json.dumps({"error": str(e)}).encode(), "application/json")
        except Exception:  # the server keeps serving; the client gets the traceback
            self._send(
                500,
                json.dumps({"error": traceback.format_exc()}).encode(),
                "application/json",
            )

    def log_message(self, fmt, *args):  # quiet
        pass


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--port", type=int, default=8008)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    server = PlanServer((args.host, args.port), args.device)
    host, port = server.server_address[:2]
    print(f"explorer at http://{host}:{port}/ on {server.device}  (ctrl-c to stop)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
