"""Where the time of one batched planner step goes on the card.

    python -m ft_fsd_path_planning_torch.profile_step [--batch 256] [--n-cones 128] [--composition]
        [--mission trackdrive|skidpad|acceleration]

Runs ``batched_step`` on perturbed corridors (seed 0) or, with ``--mission
skidpad`` or ``acceleration``, on seeded mission frames each under its own
SE(2) (first from a fresh state, the step in which every lane relocalizes,
then from the relocalized state, the step a mission spends its time in),
after a warm-up, and prints, as one JSON line a step: the step's wall time;
the wall time of each stage (relocalization on a relocalizer mission;
sorting with kernel B2 inside it; matching; path calculation, the FITPACK
fits inside it and kernel B1's refined solve, one launch of its fused entry; with
``--composition`` the composition of two bare solves and the band helpers
that the fused entry replaces), each measured with a synchronise before and
after, so the stages do not overlap; and, from ``torch.profiler``, the device time summed over all
kernels, the share of the step the device was idle, and the heaviest
kernels by device time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import torch

from ft_fsd_path_planning_torch.config import default_config
from ft_fsd_path_planning_torch.models import planner
from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes
from ft_fsd_path_planning_torch.ops import banded_cholesky, beam_search, fitpack, spline
from ft_fsd_path_planning_torch.parallel import batch, scenarios


def _timed(table: dict, name: str, fn):
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        table[name] += (time.perf_counter() - t0) * 1e3
        return out

    return wrapper


def stage_times(cfg, state, frames) -> dict:
    """Wall ms of each stage in one step, stages separated by synchronises."""
    table: dict = defaultdict(float)
    patches = [
        (planner.relocalization, "attempt_relocalization", "relocalization"),
        (planner.sorting, "run_cone_sorting", "sorting"),
        (planner.sorting.bs, "fused_beam_search", "B2 fused beam search (inside sorting)"),
        (planner.matching, "run_cone_matching", "matching"),
        (planner.pathing, "run_path_calculation", "path_calculation"),
        (planner.pathing.fpk, "fitpack_fit", "fitpack_fit (inside path_calculation)"),
        (spline, "banded_refined_solve_cuda", "B1 refined solve (inside fitpack_fit)"),
        (planner.pathing.fpk, "fitpack_parts12", "FITPACK parts 1 and 2, one kernel launch on the card (inside fitpack_fit)"),
    ]
    originals = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, name in patches:
        setattr(mod, attr, _timed(table, name, getattr(mod, attr)))
    try:
        batch.batched_step(cfg, state, frames)
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)
    return dict(table)


def device_profile(cfg, state, frames, top: int) -> dict:
    """Device time over all kernels of one step, idle share, heaviest kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batch.batched_step(cfg, state, frames)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    by_name: dict = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.device_time_total / 1e3
        by_name[e.name][1] += 1
    heaviest = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms > 0 else None,
        "device_kernels": len(kernels),
        "heaviest": [{"name": n[:90], "ms": v[0], "calls": v[1]} for n, v in heaviest],
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--n-cones", type=int, default=128)
    parser.add_argument("--top", type=int, default=12)
    parser.add_argument("--mission", choices=("trackdrive", "skidpad", "acceleration"), default="trackdrive")
    parser.add_argument(
        "--composition", action="store_true",
        help="refine through two launches of B1's bare entry and the band helpers, not through its fused entry",
    )
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    if args.composition:
        spline.banded_refined_solve_cuda = lambda a, rhs: spline._banded_solve(
            banded_cholesky.dense_to_band(a).contiguous(), rhs
        )

    cfg = default_config(getattr(MissionTypes, args.mission), n_cones=args.n_cones)
    state = batch.make_batch_state(cfg, args.batch)
    if cfg.has_relocalizer:
        frames = scenarios.mission_frame_batch(cfg, args.batch, seed=0)[0]
    else:
        frames = scenarios.make_frame_batch(cfg, args.batch, seed=0)
    _, stepped = batch.batched_step(cfg, state, frames)  # warm-up: kernel build, allocator
    torch.cuda.synchronize()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()

    starts = [("fresh state", state)]
    if cfg.has_relocalizer:
        starts.append(("relocalized state", stepped))
    for label, start in starts:
        t0 = time.perf_counter()
        out, _ = batch.batched_step(cfg, start, frames)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3

        banded_cholesky.reset_launch_count()
        beam_search.reset_launch_count()
        fitpack.loop_syncs = 0
        stages = stage_times(cfg, start, frames)
        print(json.dumps({
            "device": smi,
            "mission": args.mission,
            "from": label,
            "relocalized_rate": float(out.relocalized.float().mean()),
            "batch": args.batch,
            "n_cones": args.n_cones,
            "step_ms": step_ms,
            "stage_ms": stages,
            "sorter_search": "B2" if beam_search.launch_count else "none",
            "refined_solve": "composition of bare solves" if args.composition else "fused entry",
            "b1_launches": banded_cholesky.launch_count,
            "b2_launches": beam_search.launch_count,
            "fitpack_loop_syncs": fitpack.loop_syncs,
            **device_profile(cfg, start, frames, args.top),
        }), flush=True)


if __name__ == "__main__":
    main()
