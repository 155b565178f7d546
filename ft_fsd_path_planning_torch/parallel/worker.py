"""One rank of a multi-process run of the port, and :func:`spawn`, which
starts the ranks.

    python -m ft_fsd_path_planning_torch.parallel.worker <role> --rank R --world W --port P
        [--out DIR] [--device cuda|cpu] [--backend gloo|nccl] [--config tiny,default]
        [--global-batch B] [--seed S] [--iters N]

Each rank forms the process group at ``tcp://localhost:<port>`` and runs on
one torch thread. Roles:

* ``step``: the sharded step (`parallel/batch.py::sharded_batched_step`) on
  this rank's rows of ``make_frame_batch_numpy(cfg, B, seed)``, for each
  named configuration (``tiny``: `dryrun.tiny_config`; ``default``: the
  trackdrive default, n_cones = 128). Writes ``paths_<config>_<rank>.npy``
  and ``rank_<rank>.json`` (its slice, the metrics, the launches of both
  kernels, the uneven-batch error) to ``--out``.
* ``dryrun``: `dryrun.dryrun_rank`, printing its summary line.
* ``bench``: ``--iters`` sharded steps at ``--global-batch`` after two
  warm-up steps, between two barriers, the state carried; rank 0 prints
  the wall time as a JSON line (`scaling_bench.py`).
* ``single``: the same timing of the unsharded ``batched_step`` (and the
  batch metrics fetched to the host) at ``--global-batch``, one process
  without a group (`scaling_bench.py`'s baseline).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ft_fsd_path_planning_torch.config import default_config
from ft_fsd_path_planning_torch.models.planner import FrameInput
from ft_fsd_path_planning_torch.ops import banded_cholesky as bc
from ft_fsd_path_planning_torch.ops import beam_search as bs
from ft_fsd_path_planning_torch.parallel.batch import (
    batch_metrics,
    batched_step,
    make_batch_state,
    rank_device,
    sharded_batched_step,
)
from ft_fsd_path_planning_torch.parallel.distributed import (
    global_mesh,
    host_local_slice,
    initialize_distributed,
    make_global_batch,
    make_global_state,
)
from ft_fsd_path_planning_torch.parallel.dryrun import dryrun_rank, tiny_config
from ft_fsd_path_planning_torch.parallel.scenarios import make_frame_batch, make_frame_batch_numpy

ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def default_backend(device: str, world: int) -> str:
    """NCCL where every rank has a card of its own, else gloo (the CPU, or
    ranks that share a card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def spawn(role: str, world: int, *, device: str, backend: str | None = None, timeout: float = 900.0,
          **options) -> list[str]:
    """Run ``world`` ranks of ``role`` as processes of this interpreter and
    wait for them; returns each rank's output (stdout and stderr). Keyword
    options become the worker's flags (``global_batch=8`` ->
    ``--global-batch 8``). Raises, after stopping every rank, if one fails or
    outlives ``timeout`` seconds."""
    backend = backend or default_backend(device, world)
    port = free_port()
    flags = [f"--{k.replace('_', '-')}={v}" for k, v in options.items() if v is not None]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p
    )}
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "ft_fsd_path_planning_torch.parallel.worker", role,
             f"--rank={rank}", f"--world={world}", f"--port={port}", f"--device={device}",
             f"--backend={backend}", *flags],
            cwd=ROOT, env={**env, "LOCAL_RANK": str(rank)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(world)
    ]
    outputs: list[str] = []
    try:
        deadline = time.monotonic() + timeout
        for proc in procs:
            outputs.append(proc.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"{role} ranks outlived {timeout} s") from None
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    failed = [(r, p.returncode, out) for r, (p, out) in enumerate(zip(procs, outputs)) if p.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(f"{role} rank {r} exited {rc}:\n{out[-3000:]}" for r, rc, out in failed))
    return outputs


def _config(name: str):
    return tiny_config() if name == "tiny" else default_config(n_cones=128)


def _launches() -> dict:
    return {"B1": bc.launch_count, "B2": bs.launch_count, "B2 by instantiation": dict(bs.launch_count_by_instantiation)}


def _reset_launches() -> None:
    bc.reset_launch_count()
    bs.reset_launch_count()


def _local_inputs(cfg, mesh, global_batch: int, seed: int):
    lo, hi = host_local_slice(global_batch)
    local = FrameInput(*(a[lo:hi] for a in make_frame_batch_numpy(cfg, global_batch, seed=seed)))
    return (lo, hi), make_global_state(cfg, mesh, global_batch), make_global_batch(mesh, local, global_batch)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_step(args, mesh) -> None:
    out = Path(args.out)
    report: dict = {"rank": args.rank, "device": str(mesh.device), "configs": {}}
    try:
        host_local_slice(args.global_batch - 1)
    except ValueError as err:
        report["uneven_error"] = str(err)
    for name in args.config.split(","):
        cfg = _config(name)
        (lo, hi), states, frames = _local_inputs(cfg, mesh, args.global_batch, args.seed)
        step = sharded_batched_step(cfg, mesh)
        step(states, frames)  # warm-up: the kernels' build and load, the allocator
        _sync(mesh.device)
        _reset_launches()
        outs, _, metrics = step(states, frames)
        _sync(mesh.device)
        np.save(out / f"paths_{name}_{args.rank}.npy", outs.path.cpu().numpy())
        report["configs"][name] = {
            "lo": lo, "hi": hi, "launches": _launches(),
            "metrics": {k: float(v) for k, v in metrics._asdict().items()},
        }
    (out / f"rank_{args.rank}.json").write_text(json.dumps(report))
    print(f"[{args.rank}] ok", flush=True)


def run_bench(args, mesh) -> None:
    cfg = _config(args.config)
    _, states, frames = _local_inputs(cfg, mesh, args.global_batch, args.seed)
    step = sharded_batched_step(cfg, mesh)
    for _ in range(2):
        _, states, metrics = step(states, frames)
    _sync(mesh.device)
    dist.barrier()
    _reset_launches()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        _, states, metrics = step(states, frames)
    _sync(mesh.device)
    dist.barrier()
    elapsed = time.perf_counter() - t0
    assert float(metrics.n_frames) == args.global_batch, metrics
    print(json.dumps({"rank": args.rank, "elapsed_s": elapsed, "launches": _launches()}), flush=True)


def run_single(args, device: torch.device) -> None:
    cfg = _config(args.config)
    states = make_batch_state(cfg, args.global_batch, device)
    frames = make_frame_batch(cfg, args.global_batch, seed=args.seed, device=device)

    def step(states):
        outs, states = batched_step(cfg, states, frames)
        metrics = batch_metrics(outs)
        float(metrics.n_frames)  # to the host, as the sharded step's reduce brings them
        return states

    for _ in range(2):
        states = step(states)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        states = step(states)
    _sync(device)
    print(json.dumps({"rank": 0, "elapsed_s": time.perf_counter() - t0}), flush=True)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("role", choices=("step", "dryrun", "bench", "single"))
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--world", type=int, default=1)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--out", default=".")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--backend", default="gloo")
    parser.add_argument("--config", default="default")
    parser.add_argument("--global-batch", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--iters", type=int, default=8)
    args = parser.parse_args(argv)
    torch.set_num_threads(1)

    device = rank_device(args.device)
    if args.role == "single":
        run_single(args, device)
        return
    initialize_distributed(f"tcp://localhost:{args.port}", args.world, args.rank, args.backend, device)
    try:
        if args.role == "dryrun":
            print(dryrun_rank(device), flush=True)
        elif args.role == "step":
            run_step(args, global_mesh(device=device))
        else:
            run_bench(args, global_mesh(device=device))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
