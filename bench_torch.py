#!/usr/bin/env python3
"""Benchmark of the PyTorch port: full-pipeline path solves/s on one device.

    python3 bench_torch.py [--device cuda|cpu]

Counterpart of `bench.py` (the JAX package's bench), with the same keys
under the same names, on the port. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "solves/s", "vs_baseline": N, ...}

* ``value``: trackdrive ``batched_step`` at ``BENCH_BATCH`` (256) frames of
  ``make_frame_batch(seed=0)``, state carried from step to step, one warm
  step, then ``BENCH_ITERS`` (20) timed steps; ``vs_baseline`` = value / 100
  (the reference runs ~100 solves/s, BASELINE.md).
* ``latency_b1_p50_ms`` / ``_p99_ms``: round trip of one B = 1 step and a
  one-element fetch over ``BENCH_LAT_FRAMES`` (100) steps;
  ``link_rtt_floor_ms``: a trivial op and a one-element fetch;
  ``latency_b1_device_ms``: on a CUDA device, the CUDA kernel time of a
  chain of max(``BENCH_LAT_FRAMES``, 50) distinct B = 1 frames (state carried)
  summed under ``torch.profiler``, over the chain's length; on the CPU, where
  a step runs synchronously on the host, the chain's wall time over its
  length.
* ``replay_*``: the committed 300-frame session, loaded by the C++ loader at
  n_cones = 256, through ``replay_scan`` ``BENCH_REPLAY_ITERS`` (5) times:
  solves/s, p95 and max lateral deviation from the reference planner's
  golden paths (`demo/trackdrive_golden.npz`) and from the session's closed
  ground-truth centerline (frames after the first 10).
  ``BENCH_REPLAY_FRAMES`` replays only the session's first frames.
* ``large_map_256_solves_per_s``: ``batched_step`` at n_cones = 256 and
  ``BENCH_LARGE_BATCH`` (128) frames, max(``BENCH_ITERS`` // 2, 5) steps.
* ``device`` and ``power_limit_w``: the card's name and power limit
  (``nvidia-smi``); ``"cpu"`` and null on the CPU.

`bench.py`'s ``flops_per_solve``, ``mfu_pct`` and ``vpu_pct`` come from
XLA's cost analysis and TPU peaks and have no counterpart here. Every timed
block ends with a one-element fetch to the host: the device works
asynchronously, and without it the clock measures the launch queue.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from collections import namedtuple

import numpy as np
import torch

from ft_fsd_path_planning_torch.config import default_config, large_map_config
from ft_fsd_path_planning_torch.demo.make_session import GOLDEN_PATH, SESSION_PATH, ground_truth
from ft_fsd_path_planning_torch.device import resolve_device
from ft_fsd_path_planning_torch.models.planner import FrameInput, make_initial_state
from ft_fsd_path_planning_torch.native.loader import load_session, replay_frames
from ft_fsd_path_planning_torch.parallel.batch import (
    batched_step,
    make_batch_state,
    path_deviation,
    path_parity_deviation_paths,
    replay_scan,
)
from ft_fsd_path_planning_torch.parallel.scenarios import make_frame_batch
from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes

BASELINE_SOLVES_PER_S = 100.0  # reference: ~10 ms/frame, single thread
CHAIN_MIN = 50  # B = 1 frames in the device-time chain, at least
CENTERLINE_SKIP = 10  # cold-start frames (initial straight path)

Knobs = namedtuple("Knobs", "batch iters lat_frames large_batch replay_iters replay_frames")


def knobs_from_env() -> Knobs:
    frames = os.environ.get("BENCH_REPLAY_FRAMES")
    return Knobs(
        batch=int(os.environ.get("BENCH_BATCH", "256")),
        iters=int(os.environ.get("BENCH_ITERS", "20")),
        lat_frames=int(os.environ.get("BENCH_LAT_FRAMES", "100")),
        large_batch=int(os.environ.get("BENCH_LARGE_BATCH", "128")),
        replay_iters=int(os.environ.get("BENCH_REPLAY_ITERS", "5")),
        replay_frames=int(frames) if frames else None,
    )


def _fetch(paths: torch.Tensor) -> float:
    """One element to the host: waits for everything queued before it."""
    return float(paths[0, -1, 0].cpu())


def _throughput(cfg, batch: int, iters: int, device) -> float:
    """solves/s of ``batched_step`` with the state carried."""
    states = make_batch_state(cfg, batch, device)
    frames = make_frame_batch(cfg, batch, seed=0, device=device)
    outs, states = batched_step(cfg, states, frames)
    _fetch(outs.path)

    t0 = time.perf_counter()
    for _ in range(iters):
        outs, states = batched_step(cfg, states, frames)
    _fetch(outs.path)
    return batch * iters / (time.perf_counter() - t0)


def _link_rtt_floor_ms(device, n: int = 30) -> float:
    """Round-trip floor of the host-device link: a trivial op plus a
    one-element fetch; bounds any per-frame round trip from below."""
    x = torch.zeros(8, device=device)
    float((x + 1.0)[0].cpu())
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        float((x + 1.0)[0].cpu())
        times.append(time.perf_counter() - t0)
    return float(np.percentile(np.asarray(times) * 1e3, 50))


def _device_ms(run, device) -> float:
    """Device time of ``run()`` in ms: the CUDA kernel time summed under
    ``torch.profiler`` on a CUDA device, the wall time on the CPU."""
    if device.type == "cpu":
        t0 = time.perf_counter()
        run()
        return (time.perf_counter() - t0) * 1e3
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize(device)
    # the raw events: a chain of 50 frames holds ~230k device events, which
    # prof.events() would first build into a tree of Python objects
    cuda = torch.autograd.DeviceType.CUDA
    ns = [e.duration_ns() for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    if not ns:
        raise RuntimeError("torch.profiler recorded no CUDA kernel: no device time to report")
    return sum(ns) / 1e6


def _latency_b1(cfg, n_frames: int, device) -> dict[str, float]:
    """Single-frame (B = 1) latency: round trip per step, the link's floor,
    and the device's time per frame over a chain of distinct frames."""
    states = make_batch_state(cfg, 1, device)
    frames = make_frame_batch(cfg, 1, seed=1, device=device)
    outs, states = batched_step(cfg, states, frames)
    _fetch(outs.path)

    times = []
    for _ in range(n_frames):
        t0 = time.perf_counter()
        outs, states = batched_step(cfg, states, frames)
        _fetch(outs.path)
        times.append(time.perf_counter() - t0)
    t = np.asarray(times) * 1e3

    # the steps above warmed the kernels and the allocator for this shape
    chain_len = max(n_frames, CHAIN_MIN)
    chain = make_frame_batch(cfg, chain_len, seed=2, device=device)
    lanes = [FrameInput(*(x[i : i + 1] for x in chain)) for i in range(chain_len)]

    def run_chain():
        s = make_batch_state(cfg, 1, device)
        for frame in lanes:
            out, s = batched_step(cfg, s, frame)
        _fetch(out.path)

    device_ms = _device_ms(run_chain, device) / chain_len

    return {
        "latency_b1_device_ms": device_ms,
        "latency_b1_p50_ms": float(np.percentile(t, 50)),
        "latency_b1_p99_ms": float(np.percentile(t, 99)),
        "link_rtt_floor_ms": _link_rtt_floor_ms(device),
    }


def _replay_bench(cfg, iters: int, device, n_frames: int | None = None) -> tuple[dict, torch.Tensor]:
    """The committed session, loaded by the C++ loader, through
    ``replay_scan``: solves/s, parity against the reference planner's golden
    paths and deviation from the ground-truth centerline. Returns (keys,
    the last replay's (T, H, 4) paths)."""
    if n_frames is not None and n_frames <= CENTERLINE_SKIP:
        raise ValueError(f"a replay of {n_frames} frames leaves none after the first {CENTERLINE_SKIP}")
    arrays = load_session(SESSION_PATH, n_max=cfg.shapes.n_cones)
    if n_frames is not None:
        arrays = tuple(a[:n_frames] for a in arrays)
    frames = replay_frames(*arrays, device=device)
    t_frames = frames.cones.shape[0]
    state = make_initial_state(cfg, 1, device)
    # warm-up: kernel build and allocator, one frame
    _, paths = replay_scan(cfg, state, FrameInput(*(x[:1] for x in frames)))
    _fetch(paths[:, 0])

    t0 = time.perf_counter()
    for _ in range(iters):
        _, paths = replay_scan(cfg, state, frames)
    _fetch(paths[:, 0])
    elapsed = time.perf_counter() - t0
    paths = paths[:, 0]
    out = {"replay_solves_per_s": t_frames * iters / elapsed}

    golden = np.load(GOLDEN_PATH)["paths_plain"][:t_frames]
    parity = path_parity_deviation_paths(
        paths, torch.as_tensor(golden, dtype=torch.float32, device=device)
    ).cpu().numpy()
    out["replay_parity_dev_p95_m"] = float(np.percentile(parity, 95))
    out["replay_parity_dev_max_m"] = float(parity.max())

    # distance from the closed track centerline: path_deviation measures
    # against an open polyline, so the loop is closed by repeating its start
    _, _, _, cl, _ = ground_truth()
    cl = np.concatenate([cl, cl[:1]])
    ref_xy = torch.as_tensor(cl, dtype=torch.float32, device=device)[None].expand(t_frames, -1, -1)
    dev = path_deviation(paths, ref_xy).cpu().numpy()[CENTERLINE_SKIP:]
    out["replay_centerline_dev_p95_m"] = float(np.percentile(dev, 95))
    out["replay_centerline_dev_max_m"] = float(dev.max())
    return out, paths


def card_info(device) -> dict:
    """The device's name and power limit in watts (null on the CPU)."""
    if device.type == "cpu":
        return {"device": "cpu", "power_limit_w": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    index = device.index if device.index is not None else torch.cuda.current_device()
    limit = smi.splitlines()[index].rsplit(",", 1)[1].strip().split()[0]
    return {"device": torch.cuda.get_device_name(device), "power_limit_w": float(limit)}


def run(device=None) -> tuple[dict, torch.Tensor]:
    """The bench's JSON object and the replay's (T, H, 4) paths, on
    ``device`` (default ``cuda``; raises without a GPU unless
    ``device="cpu"``), at the depth the ``BENCH_*`` variables set."""
    dev = resolve_device(device)
    k = knobs_from_env()
    cfg = default_config(MissionTypes.trackdrive)
    solves_per_s = _throughput(cfg, k.batch, k.iters, dev)

    extras: dict[str, object] = dict(_latency_b1(cfg, k.lat_frames, dev))
    # replay runs the whole-map budget: the session's SLAM map carries ~140
    # cones, the default 128-cone budget would drop track sections
    replay, paths = _replay_bench(
        large_map_config(MissionTypes.trackdrive), k.replay_iters, dev, k.replay_frames
    )
    extras.update(replay)
    extras["large_map_256_solves_per_s"] = _throughput(
        large_map_config(MissionTypes.trackdrive), k.large_batch, max(k.iters // 2, 5), dev
    )
    extras.update(card_info(dev))
    line = {
        "metric": f"full-pipeline path solves/s (1 device, trackdrive, batch={k.batch})",
        "value": solves_per_s,
        "unit": "solves/s",
        "vs_baseline": solves_per_s / BASELINE_SOLVES_PER_S,
        **extras,
    }
    return line, paths


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    line, _ = run(args.device)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
