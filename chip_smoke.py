#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit. It builds the hand-written kernels from ``csrc/``, holds
each against its plain PyTorch version on the card, drives the trackdrive
main path (``batched_step`` at B = 256 on perturbed corridors, then the
committed 300-frame session through ``PathPlanner`` and ``replay_scan``),
checks the paths against the reference planner's golden paths, and prints
one JSON line of kernel measurements and, last, one JSON line with the
device. Any failed phase ends the run with a non-zero exit code and no
result line. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SESSION = ROOT / "ft_fsd_path_planning_tpu/demo/closed_track_session.json"
GOLDEN = ROOT / "ft_fsd_path_planning_tpu/demo/trackdrive_golden.npz"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32 outside
# the tensor cores, the rate of the kernel's scalar arithmetic
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

BATCH, N_CONES = 256, 128  # the batch-throughput size
REPLAY_N_CONES = 256  # the session flattens to 138 cones
KERNEL_REL_TOL = 1e-4  # kernel vs plain version, relative to max |x|
LATERAL_TOL = 0.01  # kernel path vs plain-solve path, metres
GOLDEN_MAX, GOLDEN_MEDIAN = 0.05, 0.01  # replay vs the reference planner, metres


def log(*args) -> None:
    print(*args, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def count_syncs(fn) -> int:
    """Host-device synchronisations ``fn`` makes (torch's sync debug mode)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in caught)


def lateral(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    from ft_fsd_path_planning_torch.parallel.batch import path_parity_deviation_paths

    return path_parity_deviation_paths(a.float(), b.float())


def spd_band_systems(rng, b: int, c: int, r: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(band (b, c, 9), rhs (b, c, r), dense (b, c, c)) of random SPD systems
    of half-bandwidth 4."""
    from ft_fsd_path_planning_torch.ops.banded_cholesky import dense_to_band

    low = np.zeros((b, c, c))
    for off in range(5):
        idx = np.arange(c - off)
        low[:, idx + off, idx] = rng.normal(size=(b, c - off)) * (1.0 if off == 0 else 0.3)
    dense = low @ np.transpose(low, (0, 2, 1)) + np.eye(c) * 0.5
    dense = torch.tensor(dense, dtype=torch.float32, device=device)
    rhs = torch.tensor(rng.normal(size=(b, c, r)), dtype=torch.float32, device=device)
    return dense_to_band(dense).contiguous(), rhs, dense


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}


def phase_build() -> None:
    from ft_fsd_path_planning_torch.ops import kernel_build

    t0 = time.perf_counter()
    libs = kernel_build.build_all()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in libs:
        for line in kernel_build.ptxas_log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {name}: {line.strip()}")


def capture_main_path_solves(cfg, dev) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Run one batched step and keep the first (band, rhs) of every distinct
    shape the kernel is given, with how often each shape occurs."""
    from ft_fsd_path_planning_torch.ops import banded_cholesky as bc
    from ft_fsd_path_planning_torch.parallel import batch, scenarios

    seen: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}
    counts: Counter = Counter()
    original = bc.banded_cholesky_solve_cuda

    def recording(band, rhs):
        counts[tuple(rhs.shape)] += 1
        seen.setdefault(tuple(rhs.shape), (band.clone(), rhs.clone()))
        return original(band, rhs)

    bc.banded_cholesky_solve_cuda = recording
    try:
        batch.batched_step(cfg, batch.make_batch_state(cfg, BATCH, dev), scenarios.make_frame_batch(cfg, BATCH, seed=1, device=dev))
        torch.cuda.synchronize()
    finally:
        bc.banded_cholesky_solve_cuda = original
    log(f"main-path solve shapes (B, C, R): {dict(counts)}")
    check(bool(seen), "the batched step never reached the banded solve")
    return [seen[s] for s, _ in counts.most_common()]


def phase_kernel_vs_plain(cfg, dev) -> dict:
    """B1 against its plain version at the main path's shapes (captured from a
    batched step, plus a synthetic (256, 28, 2)) and the two test shapes."""
    from ft_fsd_path_planning_torch.ops import banded_cholesky as bc

    rng = np.random.default_rng(0)
    captured = capture_main_path_solves(cfg, dev)
    cases = [("main path", band, rhs, None) for band, rhs in captured]
    for shape in ((256, 28, 2), (7, 51, 2), (3, 20, 1)):
        cases.append(("synthetic",) + spd_band_systems(rng, *shape, dev))

    max_err = 0.0
    for label, band, rhs, _ in cases:
        got = bc.banded_cholesky_solve_cuda(band, rhs)
        torch.cuda.synchronize()
        want = bc.banded_cholesky_solve_plain(band, rhs)
        err = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        log(f"B1 {label} {tuple(rhs.shape)}: max|kernel - plain| = {err!r} (max|x| = {scale!r})")
        check(bool(torch.isfinite(got).all()), f"kernel gave non-finite values at {tuple(rhs.shape)}")
        check(err <= KERNEL_REL_TOL * scale, f"kernel disagrees with plain at {tuple(rhs.shape)}: {err}")
        max_err = max(max_err, err)

    # timing at the main path's most frequent shape
    band, rhs = captured[0]
    b, c, r = rhs.shape
    dense = torch.zeros((b, c, c), device=dev)
    for d in range(bc.BW):
        off = d - bc.HALF_BW
        rows = torch.arange(max(0, -off), c - max(0, off), device=dev)
        dense[:, rows, rows + off] = band[:, rows, d]
    ms = cuda_ms(lambda: bc.banded_cholesky_solve_cuda(band, rhs), 200)
    plain_ms = cuda_ms(lambda: bc.banded_cholesky_solve_plain(band, rhs), 10)
    library_ms = cuda_ms(lambda: torch.linalg.solve(dense, rhs), 50)
    nbytes = 4 * (band.numel() + 2 * rhs.numel())
    flops = b * bc.solve_flops(c, r)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    log(
        f"B1 timing at {(b, c, r)}: kernel {ms!r} ms, plain {plain_ms!r} ms, "
        f"torch.linalg.solve {library_ms!r} ms, bound {max(bytes_ms, ops_ms)!r} ms "
        f"({nbytes} B, {flops} flop)"
    )
    return {
        "name": "banded_cholesky_solve",
        "route": "cuda",
        "source": "ft_fsd_path_planning_torch/csrc/banded_cholesky.cu",
        "replaces": "ft_fsd_path_planning_tpu/ops/pallas/banded_cholesky.py:36",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }


def phase_batched_step(cfg, dev) -> int:
    """batched_step at B = 256: counted run, timing, and the same batch with
    the plain solve forced, compared laterally. Returns B1's launches."""
    from ft_fsd_path_planning_torch.ops import banded_cholesky as bc
    from ft_fsd_path_planning_torch.ops import fitpack, spline
    from ft_fsd_path_planning_torch.parallel import batch, scenarios

    frames = scenarios.make_frame_batch(cfg, BATCH, seed=0, device=dev)
    state = batch.make_batch_state(cfg, BATCH, dev)
    step = lambda: batch.batched_step(cfg, state, frames)  # noqa: E731

    bc.reset_launch_count()
    fitpack.loop_syncs = 0
    out, _ = step()
    torch.cuda.synchronize()
    launches, loop_syncs = bc.launch_count, fitpack.loop_syncs
    log(f"batched_step B={BATCH}: B1 launches {launches}, FITPACK loop-condition syncs {loop_syncs}")
    check(launches > 0, "batched_step did not launch B1")
    check(out.path.shape == (BATCH, 40, 4), f"path shape {tuple(out.path.shape)}")
    check(bool(torch.isfinite(out.path).all()), "non-finite paths")
    metrics = batch.batch_metrics(out)
    log("metrics: " + json.dumps({k: float(v) for k, v in metrics._asdict().items()}))
    check(float(metrics.solve_success_rate) > 0.5, "most frames fell back to the previous path")

    syncs = count_syncs(step)
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    log(f"batched_step B={BATCH}: {step_ms!r} ms/step, {BATCH / step_ms * 1e3!r} frames/s, {syncs} host syncs/step")

    spline.banded_cholesky_solve = bc.banded_cholesky_solve_plain
    try:
        plain_out, _ = step()
        torch.cuda.synchronize()
    finally:
        spline.banded_cholesky_solve = bc.banded_cholesky_solve
    dev_m = lateral(out.path, plain_out.path)
    log(f"kernel vs plain-solve batched_step: max lateral {float(dev_m.max())!r} m, path_ok equal {bool((out.path_ok == plain_out.path_ok).all())}")
    check(float(dev_m.max()) < LATERAL_TOL, "kernel and plain-solve paths differ")
    return launches


def phase_replay(cfg, dev) -> int:
    """The 300-frame session through PathPlanner (latency, golden parity) and
    through replay_scan (must give the facade's paths). Returns B1's
    launches during the facade replay."""
    from ft_fsd_path_planning_torch import MissionTypes, PathPlanner
    from ft_fsd_path_planning_torch.models.facade import flatten_cones_by_type
    from ft_fsd_path_planning_torch.models.planner import FrameInput, make_initial_state
    from ft_fsd_path_planning_torch.ops import banded_cholesky as bc
    from ft_fsd_path_planning_torch.parallel import batch

    session = json.loads(SESSION.read_bytes())
    golden = np.load(GOLDEN)["paths_plain"]
    args = [
        (
            [np.array(c, np.float64).reshape(-1, 2) for c in f["slam_cones"]],
            np.array(f["car_position"], np.float64),
            np.array(f["car_direction"], np.float64),
        )
        for f in session
    ]

    warm = PathPlanner(MissionTypes.trackdrive, config=cfg, device=dev)
    warm.calculate_path_in_global_frame(*args[0])

    planner = PathPlanner(MissionTypes.trackdrive, config=cfg, device=dev)
    bc.reset_launch_count()
    paths, lat_ms = [], []
    for a in args:
        t0 = time.perf_counter()
        paths.append(planner.calculate_path_in_global_frame(*a))
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    launches = bc.launch_count
    paths = np.stack(paths)
    check(paths.shape == (len(session), 40, 4) and np.isfinite(paths).all(), "bad facade paths")
    devs = lateral(torch.tensor(paths), torch.tensor(golden)).numpy()
    log(
        f"PathPlanner replay {len(session)} frames: vs golden max {float(devs.max())!r} m "
        f"(frame {int(devs.argmax())}), median {float(np.median(devs))!r} m; latency p50 "
        f"{float(np.percentile(lat_ms, 50))!r} ms, p99 {float(np.percentile(lat_ms, 99))!r} ms; B1 launches {launches}"
    )
    check(launches > 0, "the facade replay did not launch B1")
    check(float(devs.max()) < GOLDEN_MAX, "replay exceeds the 5 cm bar")
    check(float(np.median(devs)) < GOLDEN_MEDIAN, "replay median exceeds 1 cm")

    flat = [flatten_cones_by_type(a[0], cfg.shapes.n_cones) for a in args]
    frames = FrameInput(
        cones=torch.tensor(np.stack([f[0] for f in flat])[:, None], device=dev),
        mask=torch.tensor(np.stack([f[1] for f in flat])[:, None], device=dev),
        position=torch.tensor(np.stack([a[1] for a in args])[:, None], dtype=torch.float32, device=dev),
        direction=torch.tensor(np.stack([a[2] for a in args])[:, None], dtype=torch.float32, device=dev),
    )
    t0 = time.perf_counter()
    _, scan_paths = batch.replay_scan(cfg, make_initial_state(cfg, 1, dev), frames)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    diff = lateral(scan_paths[:, 0], torch.tensor(paths, device=dev))
    log(f"replay_scan {len(session)} frames in {scan_s!r} s: max lateral vs PathPlanner {float(diff.max())!r} m")
    check(float(diff.max()) < 1e-3, "replay_scan and PathPlanner disagree")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU machine", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from ft_fsd_path_planning_torch import MissionTypes
    from ft_fsd_path_planning_torch.config import default_config

    dev = torch.device("cuda")
    device = phase_device()
    phase_build()
    cfg = default_config(n_cones=N_CONES)
    kernel = phase_kernel_vs_plain(cfg, dev)
    kernel["launches"] = phase_batched_step(cfg, dev)
    phase_replay(default_config(MissionTypes.trackdrive, n_cones=REPLAY_N_CONES), dev)
    log(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
