#!/usr/bin/env python3
"""Golden paths of the mission sessions, from the JAX package.

    JAX_PLATFORMS=cpu python tools/make_torch_missions_golden.py [--frames N] [--out FILE]

Runs the seeded mission sessions of
`ft_fsd_path_planning_torch/parallel/scenarios.py::mission_sessions` (skidpad
with the full and with the partial view, acceleration, EBS test) through the JAX package's
``PathPlanner`` at n_cones = 128 and writes, per session, the paths
``(frames, 40, 4)``, per frame whether the path is a fresh solve
(``path_ok``; False where the planner fell back to its previous path), the
frame of first relocalization (-1 if never) and the ``relocalization_info``
(rotation, translation) into
`ft_fsd_path_planning_torch/assets/missions_golden.npz`. A machine without
JAX holds the PyTorch port against this file (`chip_smoke.py`). ``--frames``
cuts every session to its first N frames (the tests regenerate a prefix
this way and compare it with the committed file).

Where the JAX package falls back on a frame (on the acceleration hairpin a
float32 factorization of the smoothing fit's normal equations breaks down
and the fit carries NaN), the session is run a second time with the spline
engine's SPD solve done in float64 on the host and nothing else changed:
``paths_float64_solver`` and ``path_ok_float64_solver`` are the reference
for those frames. The port does not fall back there (its p-iteration
retries a broken factorization with a larger p), so this is what its paths
on those frames are held against.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ft_fsd_path_planning_torch.parallel import scenarios  # noqa: E402

DEFAULT_OUT = ROOT / "ft_fsd_path_planning_torch/assets/missions_golden.npz"
N_CONES = 128


@contextlib.contextmanager
def recorded_path_ok(planner):
    """Record ``path_ok`` of every step a facade of either package makes
    inside the block. The JAX facade holds its jitted step as an attribute;
    the port's calls its module's ``planner_step``."""
    oks: list[bool] = []

    def recording(step):
        def wrapper(*args, **kwargs):
            out, state = step(*args, **kwargs)
            oks.append(bool(out.path_ok.reshape(-1)[0]))
            return out, state

        return wrapper

    holder = planner if hasattr(planner, "_step") else sys.modules[type(planner).__module__]
    name = "_step" if holder is planner else "planner_step"
    original = getattr(holder, name)
    setattr(holder, name, recording(original))
    try:
        yield oks
    finally:
        setattr(holder, name, original)


def run_session(planner, frames) -> dict[str, np.ndarray]:
    """Drive ``frames`` through a facade of either package."""
    paths, first = [], -1
    with recorded_path_ok(planner) as oks:
        for i, (cones, pos, direction) in enumerate(frames):
            paths.append(planner.calculate_path_in_global_frame(cones, pos, direction))
            if first < 0 and planner.relocalization_info is not None:
                first = i
    info = planner.relocalization_info
    return {
        "paths": np.stack(paths),
        "path_ok": np.asarray(oks, bool),
        "first_relocalized": np.asarray(first),
        "rotation": np.asarray(np.nan if info is None else info.rotation),
        "translation": np.full(2, np.nan) if info is None else np.asarray(info.translation, np.float64),
    }


@contextlib.contextmanager
def float64_solver():
    """Inside the block the JAX package's FITPACK engine solves its SPD
    systems in float64 on the host (numpy) and casts the solution back;
    every other operation stays as it is. Planners must be built inside."""
    import jax

    from ft_fsd_path_planning_tpu.models import facade
    from ft_fsd_path_planning_tpu.ops import fitpack

    def host_solve(a, b):
        return np.linalg.solve(np.asarray(a, np.float64), np.asarray(b, np.float64)).astype(b.dtype)

    def solve(a, b):
        return jax.pure_callback(host_solve, jax.ShapeDtypeStruct(b.shape, b.dtype), a, b, vmap_method="broadcast_all")

    original = fitpack._solve_spd_banded
    fitpack._solve_spd_banded = solve
    facade._jitted_step.cache_clear()  # a step traced before would keep the other solver
    try:
        yield
    finally:
        fitpack._solve_spd_banded = original
        facade._jitted_step.cache_clear()


def run_jax_session(mission_name: str, frames, float64: bool = False) -> dict[str, np.ndarray]:
    """One session through a new JAX ``PathPlanner``; with ``float64`` under
    `float64_solver`."""
    from ft_fsd_path_planning_tpu import MissionTypes, PathPlanner
    from ft_fsd_path_planning_tpu.config import default_config

    mission = getattr(MissionTypes, mission_name)
    with float64_solver() if float64 else contextlib.nullcontext():
        planner = PathPlanner(mission, config=default_config(mission, n_cones=N_CONES))
        return run_session(planner, frames)


def make_golden(n_frames: int | None = None) -> dict[str, np.ndarray]:
    out = {}
    for name, (mission_name, frames) in scenarios.mission_sessions(n_frames).items():
        run = run_jax_session(mission_name, frames)
        for key, value in run.items():
            out[f"{name}/{key}"] = value
        fell_back = np.nonzero(~run["path_ok"])[0].tolist()
        print(
            f"{name}: {len(frames)} frames, first relocalized at {int(out[f'{name}/first_relocalized'])}, "
            f"rotation {float(out[f'{name}/rotation'])!r}, translation {out[f'{name}/translation'].tolist()}, "
            f"fell back to the previous path on frames {fell_back}",
            flush=True,
        )
        if fell_back:
            again = run_jax_session(mission_name, frames, float64=True)
            out[f"{name}/paths_float64_solver"] = again["paths"]
            out[f"{name}/path_ok_float64_solver"] = again["path_ok"]
            print(
                f"{name} with the float64 solver: fell back on frames {np.nonzero(~again['path_ok'])[0].tolist()}",
                flush=True,
            )
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=None)
    parser.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = parser.parse_args()
    golden = make_golden(args.frames)
    golden = {k: v.astype(np.float32) if "/paths" in k else v for k, v in golden.items()}
    np.savez_compressed(args.out, **golden)
    print(f"wrote {args.out} ({args.out.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
