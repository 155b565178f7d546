"""Each FITPACK fit of the path calculation on its own: kernels, syncs and
milliseconds.

    python -m ft_fsd_path_planning_torch.profile_pathing [--batch 256] [--n-cones 128] [--reps 5]
        [--device cuda|cpu]

Counterpart of `tools/profile_pathing.py`, which times the FITPACK fit and
the curvature filter on synthetic inputs. Here the fits are captured where
the planner makes them: one ``batched_step`` on perturbed corridors (seed 0)
records the inputs of every ``fitpack_fit`` call with its call site in
``models/pathing.py``, and each captured fit is then run again on its own:
the centerline fit (`_fit_and_densify`, from `run_path_calculation`; the JAX
package's ``models/pathing.py:103``, called at :475), the refit in
`_parameterize_path` (JAX :347) and the final refit of
`run_path_calculation` (JAX :508). The one-off fit of the initial path (768
samples, `initial_path_state`; JAX :582), made when the state is built, is
reported apart, with its refit. For each: the device kernels one run launches
(``torch.profiler``), the host syncs it makes
(``torch.cuda.set_sync_debug_mode``) and its wall time with a synchronise on
either side, the median of ``--reps`` runs. On the CPU the unit is the
torch call and syncs are absent (null). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from ft_fsd_path_planning_torch import profile_device as pd

#: the fit sites by the function of models/pathing.py that calls fitpack_fit
SITES = {
    "_fit_and_densify": "centerline fit (JAX pathing.py:103, called at :475)",
    "_parameterize_path": "refit in parameterize (JAX pathing.py:347)",
    "run_path_calculation": "final refit (JAX pathing.py:508)",
}


def _site(frames: list[tuple[str, int, str]]) -> tuple[str, str]:
    """(site name, port lines) of a fitpack_fit call from its stack; the
    fits of building the initial state are named apart."""
    pathing = [(ln, fn) for f, ln, fn in frames if f == "models/pathing.py"]
    fns = [fn for _, fn in pathing]
    name = SITES.get(fns[0] if fns else None, f"other ({fns})")
    if "initial_path_state" in fns:
        name = f"initial path, once (JAX pathing.py:582): {fns[0]}"
    return name, " <- ".join(f"models/pathing.py:{ln} {fn}" for ln, fn in pathing[:2])


def capture_fits(cfg, batch_size: int, device: torch.device) -> list[dict]:
    """The inputs of every fitpack_fit call of building the state and one
    batched step, with its site, in call order."""
    from ft_fsd_path_planning_torch.ops import fitpack
    from ft_fsd_path_planning_torch.parallel import batch, scenarios

    original = fitpack.fitpack_fit
    fits: list[dict] = []

    def recording(points, mask, smoothing):
        name, lines = _site(pd._port_frames(sys._getframe(1)))
        fits.append({"site": name, "lines": lines, "args": (points.clone(), mask.clone(), smoothing)})
        return original(points, mask, smoothing)

    fitpack.fitpack_fit = recording
    try:
        state = batch.make_batch_state(cfg, batch_size, device)
        frames = scenarios.make_frame_batch(cfg, batch_size, seed=0, device=device)
        batch.batched_step(cfg, state, frames)
    finally:
        fitpack.fitpack_fit = original
    return fits


def measure_fit(args: tuple, device: torch.device, reps: int) -> dict:
    """Kernels (or torch calls on the CPU), syncs and the median ms of one
    fit run on its own."""
    from ft_fsd_path_planning_torch.ops import fitpack

    run = lambda: fitpack.fitpack_fit(*args)  # noqa: E731
    run()
    times = []
    for _ in range(reps):
        pd._sync(device)
        t0 = time.perf_counter()
        run()
        pd._sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    counted = pd.attribute_kernels(run, device)
    syncs = pd.attribute_syncs(run, device)
    return {
        counted["unit"]: counted["total"],
        "device_ms" if device.type == "cuda" else "host_ms_of_calls": counted["total_ms"],
        "syncs": None if syncs is None else sum(v["syncs"] for v in syncs.values()),
        "ms": statistics.median(times),
        "points": list(args[0].shape),
    }


def main(argv: list[str] | None = None) -> dict:
    from ft_fsd_path_planning_torch.config import default_config
    from ft_fsd_path_planning_torch.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--n-cones", type=int, default=128)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = default_config(n_cones=args.n_cones)
    fits = capture_fits(cfg, args.batch, device)
    sites = []
    for fit in fits:
        sites.append({"site": fit["site"], "lines": fit["lines"], **measure_fit(fit["args"], device, args.reps)})
    out = {"device": pd.device_name(device), "batch": args.batch, "n_cones": args.n_cones, "fits": sites}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
