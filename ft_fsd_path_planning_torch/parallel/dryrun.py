"""A multi-process dry run of the sharded batched step.

Counterpart of `__graft_entry__.py` (`_tiny_config`, `dryrun_multichip`) at
the root of the repository: one sharded batched step at the whole-SLAM-map
shape budget (`config.large_map_config`, n_cones = 256), two frames a
process, through the multi-process feeding path: `initialize_distributed`,
`host_local_slice`, `make_global_batch` and `sharded_batched_step`. Where
the JAX function runs one process over a mesh of devices, here each rank is
a process of its own (`parallel/worker.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from ft_fsd_path_planning_torch.config import (
    ShapeBudget,
    SortingConfig,
    default_config,
    large_map_config,
)
from ft_fsd_path_planning_torch.device import resolve_device
from ft_fsd_path_planning_torch.models.planner import FrameInput
from ft_fsd_path_planning_torch.parallel.batch import make_batch_state, sharded_batched_step, tree_map
from ft_fsd_path_planning_torch.parallel.distributed import (
    global_mesh,
    host_local_slice,
    make_global_batch,
)
from ft_fsd_path_planning_torch.parallel.scenarios import make_frame_batch_numpy
from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes

SUMMARY_PREFIX = "dryrun_multichip ok:"


def tiny_config():
    """Small static shape budget for fast dry runs: beam width 8, max length
    8, 32 cones (the JAX package's ``__graft_entry__._tiny_config``)."""
    return default_config(
        MissionTypes.trackdrive,
        sorting=SortingConfig(max_length=8, beam_width=8),
        shapes=ShapeBudget(
            n_cones=32,
            config_len=8,
            side_len=16,
            dense_samples=192,
            curvature_window=15,
            global_window=64,
        ),
    )


def dryrun_rank(device: str | torch.device | None = None) -> str:
    """The dry run on this process, in a process group already formed (or
    on this process alone): returns the one-line summary."""
    cfg = large_map_config(MissionTypes.trackdrive)
    mesh = global_mesh(device=device)
    batch = 2 * mesh.size
    lo, hi = host_local_slice(batch)
    local_states = tree_map(lambda x: x[lo:hi], make_batch_state(cfg, batch, "cpu"))
    local_frames = FrameInput(*(a[lo:hi] for a in make_frame_batch_numpy(cfg, batch)))
    states = make_global_batch(mesh, local_states, batch)
    frames = make_global_batch(mesh, local_frames, batch)

    step = sharded_batched_step(cfg, mesh)
    outs, _, metrics = step(states, frames)
    paths = outs.path.cpu().numpy()
    assert paths.shape == (hi - lo, cfg.path.mpc_prediction_horizon, 4), paths.shape
    assert np.all(np.isfinite(paths)), "non-finite path output"
    assert float(metrics.n_frames) == batch, metrics
    assert 0.0 <= float(metrics.solve_success_rate) <= 1.0
    return (
        f"{SUMMARY_PREFIX} {mesh.size} devices, batch {batch}, "
        f"mean path length {float(metrics.mean_path_length):.2f} m, "
        f"solve success {float(metrics.solve_success_rate):.2f}"
    )


def dryrun_multichip(n_ranks: int, device: str | torch.device | None = None, timeout: float = 900.0) -> str:
    """Run the dry run in ``n_ranks`` processes, one rank each, on ``device``
    (default ``cuda``; ``cpu`` on the host), and print and return rank 0's
    summary. The ranks form a gloo group where they share a card or run on
    the CPU, an NCCL group where each has a card of its own. Raises if a
    rank fails."""
    from ft_fsd_path_planning_torch.parallel import worker  # it imports this module

    dev = resolve_device(device)
    outputs = worker.spawn("dryrun", n_ranks, device=str(dev), timeout=timeout)
    line = next(ln for ln in outputs[0].splitlines() if ln.startswith(SUMMARY_PREFIX))
    print(line)
    return line
