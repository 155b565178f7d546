#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit. It builds the hand-written kernels from ``csrc/`` (B1,
the banded Cholesky solve, and B2, the fused beam search of the cone
sorter), holds each against its plain PyTorch version on the card at the
shapes the main path gives it, and drives the trackdrive main path:
``batched_step`` at B = 256 on perturbed corridors (with B2 and, for
comparison, with the sorter's scan), then the committed 300-frame session
through ``PathPlanner`` without and with the sorting cache and through
``replay_scan``. It checks the paths against the reference planner's golden
paths, and prints one JSON line of kernel measurements and, last, one JSON
line with the device. Any failed phase ends the run with a non-zero exit
code and no result line. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
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
KERNEL_REL_TOL = 1e-4  # B1 vs plain version, relative to max |x|
B2_FLOAT_TOL = 1e-6  # B2 vs plain version, float feature rows, absolute (integer-coded rows: equal)
SESSION_CAPTURE_FRAMES = (0, 75, 150, 225)  # session frames whose searches B2 is checked on
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


def reset_counts() -> None:
    from ft_fsd_path_planning_torch.ops import banded_cholesky as bc
    from ft_fsd_path_planning_torch.ops import beam_search as bs

    bc.reset_launch_count()
    bs.reset_launch_count()


def read_counts(path: str) -> dict:
    """Launches of both kernels since reset_counts(); every kernel must have
    been launched by the path just driven."""
    from ft_fsd_path_planning_torch.ops import banded_cholesky as bc
    from ft_fsd_path_planning_torch.ops import beam_search as bs

    counts = {"B1": bc.launch_count, "B2": bs.launch_count}
    for name, n in counts.items():
        check(n > 0, f"{path} did not launch {name}")
    return counts


@contextlib.contextmanager
def sorter_scan():
    """Run the sorter's scan instead of kernel B2 inside the block."""
    before = os.environ.get("FT_FSD_FUSED_BEAM")
    os.environ["FT_FSD_FUSED_BEAM"] = "0"
    try:
        yield
    finally:
        if before is None:
            del os.environ["FT_FSD_FUSED_BEAM"]
        else:
            os.environ["FT_FSD_FUSED_BEAM"] = before


def session_args() -> list[tuple]:
    session = json.loads(SESSION.read_bytes())
    return [
        (
            [np.array(c, np.float64).reshape(-1, 2) for c in f["slam_cones"]],
            np.array(f["car_position"], np.float64),
            np.array(f["car_direction"], np.float64),
        )
        for f in session
    ]


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


def phase_b1_vs_plain(cfg, dev) -> dict:
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


def capture_searches(run) -> tuple[tuple, dict]:
    """Call ``run()`` and return the (node_table, feats0, alive0, params) and
    keyword arguments of the last fused search it launched."""
    from ft_fsd_path_planning_torch.ops import beam_search as bs

    seen = []
    original = bs.fused_beam_search_cuda

    def recording(*args, **kwargs):
        seen.append((tuple(a.clone() for a in args), kwargs))
        return original(*args, **kwargs)

    bs.fused_beam_search_cuda = recording
    try:
        run()
        torch.cuda.synchronize()
    finally:
        bs.fused_beam_search_cuda = original
    check(bool(seen), "the sorter never reached the fused beam search")
    return seen[-1]


def phase_b2_vs_plain(cfg, replay_cfg, dev) -> dict:
    """B2 against its plain version on searches captured from the main path
    (one batched step at B = 256, N = 128; session frames at N = 256) and on
    a seeded batch whose G is no multiple of 32; then its time at the batch
    shape beside its bound, the plain version and the sorter's scan."""
    from ft_fsd_path_planning_torch.models import sorting
    from ft_fsd_path_planning_torch.models.facade import flatten_cones_by_type
    from ft_fsd_path_planning_torch.models.planner import FrameInput, make_initial_state, planner_step
    from ft_fsd_path_planning_torch.ops import beam_search as bs
    from ft_fsd_path_planning_torch.parallel import batch, scenarios

    def batched(n_frames, seed):
        frames = scenarios.make_frame_batch(cfg, n_frames, seed=seed, device=dev)
        return lambda: batch.batched_step(cfg, batch.make_batch_state(cfg, n_frames, dev), frames)

    def session_frame(args):
        pts, mask = flatten_cones_by_type(args[0], replay_cfg.shapes.n_cones)
        frame = FrameInput(
            cones=torch.as_tensor(pts, device=dev)[None],
            mask=torch.as_tensor(mask, device=dev)[None],
            position=torch.as_tensor(args[1].astype(np.float32), device=dev)[None],
            direction=torch.as_tensor(args[2].astype(np.float32), device=dev)[None],
        )
        return lambda: planner_step(replay_cfg, make_initial_state(replay_cfg, 1, dev), frame)

    main = capture_searches(batched(BATCH, 1))
    cases = [(f"main path, batched_step B={BATCH}", *main)]
    frames = session_args()
    for i in SESSION_CAPTURE_FRAMES:
        cases.append((f"main path, session frame {i}", *capture_searches(session_frame(frames[i]))))
    cases.append(("seeded batch B=37", *capture_searches(batched(37, 5))))

    l = cfg.sorting.max_length
    int_rows = list(range(l)) + [l, l + 1, l + 7]  # configs, length, done, last_idx
    float_rows = [r for r in range(bs.feature_rows(l)) if r not in int_rows]
    max_err = 0.0
    for label, args, kwargs in cases:
        got_f, got_a = bs.fused_beam_search_cuda(*args, **kwargs)
        torch.cuda.synchronize()
        want_f, want_a = bs.fused_beam_search_plain(*args, **kwargs)
        err = float((got_f[:, float_rows] - want_f[:, float_rows]).abs().max())
        ints_equal = bool(torch.equal(got_f[:, int_rows], want_f[:, int_rows]))
        alive_equal = bool(torch.equal(got_a, want_a))
        log(
            f"B2 {label}: G={args[0].shape[0]} N={args[0].shape[1]}: configs/length/done/last_idx equal "
            f"{ints_equal}, alive equal {alive_equal} ({int(got_a.sum())} survivors), "
            f"max|kernel - plain| on the float rows = {err!r}"
        )
        check(bool(torch.isfinite(got_f).all()), f"B2 gave non-finite values ({label})")
        check(ints_equal and alive_equal, f"B2 disagrees with its plain version on integer rows or alive ({label})")
        check(err <= B2_FLOAT_TOL, f"B2 disagrees with its plain version ({label}): {err}")
        max_err = max(max_err, err)

    # timing at the batch shape
    _, args, kwargs = cases[0]
    table, feats0, alive0, params = args
    g, n = table.shape[:2]
    k, c = kwargs["k"], kwargs["c"]
    ms = cuda_ms(lambda: bs.fused_beam_search_cuda(*args, **kwargs), 100)
    plain_ms = cuda_ms(lambda: bs.fused_beam_search_plain(*args, **kwargs), 3)
    cone_type = torch.where(params[:, bs.P_SIGN] > 0, 2, 1)  # ConeTypes.LEFT, RIGHT
    scan_ms = cuda_ms(
        lambda: sorting._beam_scan(
            cfg.sorting, feats0, alive0 > 0.5, cone_type, params[:, :2].contiguous(),
            params[:, 2:4].contiguous(), table, params[:, bs.P_TLEN],
        ),
        3,
    )
    nbytes = bs.search_bytes(g, n, k, l, c)
    flops = g * bs.search_flops(n, k, l, c)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    log(
        f"B2 timing at G={g} N={n} K={k} L={l} C={c}: kernel {ms!r} ms, plain {plain_ms!r} ms, "
        f"the sorter's scan (the repo's other implementation, eager PyTorch) {scan_ms!r} ms, "
        f"bound {max(bytes_ms, ops_ms)!r} ms ({nbytes} B -> {bytes_ms!r} ms, {flops} flop -> {ops_ms!r} ms); "
        "no PyTorch call computes this function"
    )
    _, args1, kwargs1 = cases[1]
    ms1 = cuda_ms(lambda: bs.fused_beam_search_cuda(*args1, **kwargs1), 100)
    log(f"B2 timing at G={args1[0].shape[0]} N={args1[0].shape[1]} (one frame of the replay): kernel {ms1!r} ms")
    return {
        "name": "fused_beam_search",
        "route": "cuda",
        "source": "ft_fsd_path_planning_torch/csrc/beam_search.cu",
        "replaces": "ft_fsd_path_planning_tpu/ops/pallas/beam_search.py:108",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "scan_ms": scan_ms,
        "one_frame_ms": ms1,
    }


def time_step(step) -> tuple[float, int]:
    """(ms per call over 5 calls after the caller's warm-up, host syncs of one call)."""
    syncs = count_syncs(step)
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3, syncs


def phase_batched_step(cfg, dev) -> dict:
    """batched_step at B = 256: counted run, timing, the same batch with the
    plain solve forced and with the sorter's scan in place of B2, compared.
    Returns both kernels' launches in one step."""
    from ft_fsd_path_planning_torch.ops import banded_cholesky as bc
    from ft_fsd_path_planning_torch.ops import beam_search as bs
    from ft_fsd_path_planning_torch.ops import fitpack, spline
    from ft_fsd_path_planning_torch.parallel import batch, scenarios

    frames = scenarios.make_frame_batch(cfg, BATCH, seed=0, device=dev)
    state = batch.make_batch_state(cfg, BATCH, dev)
    step = lambda: batch.batched_step(cfg, state, frames)  # noqa: E731

    reset_counts()
    fitpack.loop_syncs = 0
    out, _ = step()
    torch.cuda.synchronize()
    launches, loop_syncs = read_counts("batched_step"), fitpack.loop_syncs
    log(f"batched_step B={BATCH}: launches {launches}, FITPACK loop-condition syncs {loop_syncs}")
    check(out.path.shape == (BATCH, 40, 4), f"path shape {tuple(out.path.shape)}")
    check(bool(torch.isfinite(out.path).all()), "non-finite paths")
    metrics = batch.batch_metrics(out)
    log("metrics: " + json.dumps({k: float(v) for k, v in metrics._asdict().items()}))
    check(float(metrics.solve_success_rate) > 0.5, "most frames fell back to the previous path")

    step_ms, syncs = time_step(step)
    log(f"batched_step B={BATCH} with B2: {step_ms!r} ms/step, {BATCH / step_ms * 1e3!r} frames/s, {syncs} host syncs/step")

    spline.banded_cholesky_solve = bc.banded_cholesky_solve_plain
    try:
        plain_out, _ = step()
        torch.cuda.synchronize()
    finally:
        spline.banded_cholesky_solve = bc.banded_cholesky_solve
    dev_m = lateral(out.path, plain_out.path)
    log(f"kernel vs plain-solve batched_step: max lateral {float(dev_m.max())!r} m, path_ok equal {bool((out.path_ok == plain_out.path_ok).all())}")
    check(float(dev_m.max()) < LATERAL_TOL, "kernel and plain-solve paths differ")

    with sorter_scan():
        reset_counts()
        scan_out, _ = step()
        torch.cuda.synchronize()
        check(bs.launch_count == 0, "FT_FSD_FUSED_BEAM=0 still launched B2")
        scan_ms, scan_syncs = time_step(step)
    log(f"batched_step B={BATCH} with the sorter's scan: {scan_ms!r} ms/step, {BATCH / scan_ms * 1e3!r} frames/s, {scan_syncs} host syncs/step")
    differs = torch.zeros(BATCH, dtype=torch.bool, device=dev)
    for name in ("sorted_left", "sorted_left_mask", "sorted_right", "sorted_right_mask"):
        a, b = getattr(out, name), getattr(scan_out, name)
        differs |= (a != b).reshape(BATCH, -1).any(dim=1)
    dev_m = lateral(out.path, scan_out.path)
    log(
        f"B2 vs scan batched_step: frames sorted differently {int(differs.sum())} "
        f"{torch.nonzero(differs).flatten().tolist()}, max lateral {float(dev_m.max())!r} m, "
        f"path_ok equal {bool((out.path_ok == scan_out.path_ok).all())}"
    )
    check(not bool(differs.any()), "B2 and the scan sort frames differently")
    check(float(dev_m.max()) < LATERAL_TOL, "B2 and scan paths differ")
    check(bool((out.path_ok == scan_out.path_ok).all()), "B2 and scan disagree on path_ok")
    return launches


def replay_facade(planner, args, golden, label: str) -> tuple[np.ndarray, dict]:
    """Drive the session through ``planner``; check shape, finiteness and the
    golden bars; returns (paths, both kernels' launches)."""
    reset_counts()
    paths, lat_ms, hit = [], [], []
    for a in args:
        hits_before = planner.sort_cache_hits
        t0 = time.perf_counter()
        paths.append(planner.calculate_path_in_global_frame(*a))
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        hit.append(planner.sort_cache_hits > hits_before)
    launches = read_counts(label)
    paths = np.stack(paths)
    check(paths.shape == (len(args), 40, 4) and np.isfinite(paths).all(), f"bad facade paths ({label})")
    devs = lateral(torch.tensor(paths), torch.tensor(golden)).numpy()
    log(
        f"{label} {len(args)} frames: vs golden max {float(devs.max())!r} m "
        f"(frame {int(devs.argmax())}), median {float(np.median(devs))!r} m; latency p50 "
        f"{float(np.percentile(lat_ms, 50))!r} ms, p99 {float(np.percentile(lat_ms, 99))!r} ms; launches {launches}"
    )
    if any(hit):  # hit and miss frames interleave, so their latencies compare within the run
        lat, hit = np.array(lat_ms), np.array(hit)
        log(
            f"{label}: median latency of the {int(hit.sum())} cache-hit frames {float(np.median(lat[hit]))!r} ms, "
            f"of the {int((~hit).sum())} miss frames {float(np.median(lat[~hit]))!r} ms"
        )
    check(float(devs.max()) < GOLDEN_MAX, f"{label} exceeds the 5 cm bar")
    check(float(np.median(devs)) < GOLDEN_MEDIAN, f"{label} median exceeds 1 cm")
    return paths, launches


def phase_replay(cfg, dev) -> dict:
    """The 300-frame session through PathPlanner (latency, golden parity),
    through PathPlanner with the sorting cache, and through replay_scan
    (must give the facade's paths). Returns both kernels' launches of the
    two facade replays."""
    from ft_fsd_path_planning_torch import MissionTypes, PathPlanner
    from ft_fsd_path_planning_torch.models.facade import flatten_cones_by_type
    from ft_fsd_path_planning_torch.models.planner import FrameInput, make_initial_state
    from ft_fsd_path_planning_torch.parallel import batch

    golden = np.load(GOLDEN)
    args = session_args()

    warm = PathPlanner(MissionTypes.trackdrive, config=cfg, device=dev)
    warm.calculate_path_in_global_frame(*args[0])

    planner = PathPlanner(MissionTypes.trackdrive, config=cfg, device=dev)
    paths, launches = replay_facade(planner, args, golden["paths_plain"], "PathPlanner replay")

    cached_cfg = dataclasses.replace(cfg, experimental_performance_improvements=True)
    cached = PathPlanner(MissionTypes.trackdrive, config=cached_cfg, device=dev)
    _, cached_launches = replay_facade(cached, args, golden["paths_cached"], "PathPlanner replay with the sort cache")
    ref_hits, ref_checks = (int(x) for x in golden["ref_cache_hits"])
    log(
        f"sort cache: {cached.sort_cache_hits} of {len(args)} frames hit (both sides at once); "
        f"the reference planner hit {ref_hits} of {ref_checks} per-side checks"
    )
    check(cached.sort_cache_hits / len(args) > 0.2, "the sort cache did not engage")
    check(cached_launches["B2"] + cached.sort_cache_hits == len(args), "a cache miss did not launch B2 once")

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
    log(f"replay_scan {len(args)} frames in {scan_s!r} s: max lateral vs PathPlanner {float(diff.max())!r} m")
    check(float(diff.max()) < 1e-3, "replay_scan and PathPlanner disagree")
    return {"replay": launches, "cached_replay": cached_launches}


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
    replay_cfg = default_config(MissionTypes.trackdrive, n_cones=REPLAY_N_CONES)
    kernels = {"B1": phase_b1_vs_plain(cfg, dev), "B2": phase_b2_vs_plain(cfg, replay_cfg, dev)}
    step_launches = phase_batched_step(cfg, dev)
    replay_launches = phase_replay(replay_cfg, dev)
    for name, kernel in kernels.items():
        kernel["launches"] = step_launches[name]  # one batched_step at B = 256
        kernel["launches_replay"] = replay_launches["replay"][name]
        kernel["launches_cached_replay"] = replay_launches["cached_replay"][name]
    log(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
