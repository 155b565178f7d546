"""Weak scaling over processes on one card: solves/s at 1, 2 and 4
processes, the batch of each process fixed.

    python -m ft_fsd_path_planning_torch.scaling_bench [--per-process-batch 64] [--processes 1 2 4]
        [--iters 8] [--backend gloo|nccl] [--device cuda|cpu] [--out build/scaling_torch.json]

Counterpart of `tools/scaling_bench.py`, which shards the batch over the
devices of one process's mesh. Here each point is N processes
(`parallel/worker.py`, role ``bench``), each a gloo rank with its own CUDA
context on the same card, running the sharded step
(`parallel/batch.py::sharded_batched_step`, the state carried) on its own
``--per-process-batch`` rows of a global batch of N times that, at the
default trackdrive configuration (n_cones = 128). ``--backend nccl`` runs
the one-process point on an NCCL group instead (NCCL refuses two ranks on
one card). Each point also times the unsharded step (`batched_step` and its
metrics fetched to the host) at the same global batch in one process
without a group (role ``single``). Reported per point:

* ``solves_per_s``: global batch x iterations over the wall time between
  the two barriers around them (rank 0's clock);
* ``single_program_solves_per_s``: the unsharded step at the same batch;
* ``weak_scaling_efficiency``: solves/s over N times the one-process point's;
* ``wiring_efficiency``: solves/s over the unsharded step's at the same
  global batch, what splitting the batch over processes gains or costs;

with ``os.cpu_count()``, the card's name and its power limit. Prints one
JSON line and writes it to ``build/scaling_torch.json`` (never to
``SCALING.json``, which belongs to the JAX tool).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
from pathlib import Path

from ft_fsd_path_planning_torch.parallel import worker

ROOT = Path(__file__).resolve().parents[1]


def _elapsed(outputs: list[str]) -> float:
    """Rank 0's wall time of the timed iterations."""
    for line in outputs[0].splitlines():
        if line.startswith("{"):
            return float(json.loads(line)["elapsed_s"])
    raise RuntimeError(f"rank 0 reported no time:\n{outputs[0][-2000:]}")


def _launches(outputs: list[str]) -> list[dict]:
    return [json.loads(ln).get("launches", {}) for out in outputs for ln in out.splitlines() if ln.startswith("{")]


def card(device: str) -> str:
    if not device.startswith("cuda"):
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def run(per_process: int, processes: list[int], iters: int, backend: str, device: str,
        timeout: float = 1200.0) -> dict:
    points = []
    base = None
    for n in processes:
        global_batch = n * per_process
        point_backend = backend if n == 1 else "gloo"
        common = {"device": device, "timeout": timeout, "global_batch": global_batch, "iters": iters}
        sharded = worker.spawn("bench", n, backend=point_backend, **common)
        single = worker.spawn("single", 1, backend="gloo", **common)
        sps = global_batch * iters / _elapsed(sharded)
        single_sps = global_batch * iters / _elapsed(single)
        base = base if base is not None else sps / n
        points.append({
            "n_processes": n,
            "backend": point_backend,
            "global_batch": global_batch,
            "solves_per_s": sps,
            "single_program_solves_per_s": single_sps,
            "weak_scaling_efficiency": sps / (base * n),
            "wiring_efficiency": sps / single_sps,
            "launches_per_rank": _launches(sharded),
        })
    return {
        "harness": "weak scaling over processes on one card, batch per process fixed",
        "per_process_batch": per_process,
        "iters": iters,
        "config": "trackdrive default, n_cones 128",
        "device": card(device),
        "cpu_count": os.cpu_count(),
        "points": points,
    }


def main(argv: list[str] | None = None) -> dict:
    from ft_fsd_path_planning_torch.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--per-process-batch", type=int, default=64)
    parser.add_argument("--processes", type=int, nargs="+", default=[1, 2, 4])
    parser.add_argument("--iters", type=int, default=8)
    parser.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--out", default=str(ROOT / "build" / "scaling_torch.json"))
    args = parser.parse_args(argv)
    device = str(resolve_device(args.device))
    result = run(args.per_process_batch, args.processes, args.iters, args.backend, device)
    line = json.dumps(result)
    print(line, flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    return result


if __name__ == "__main__":
    main()
