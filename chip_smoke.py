#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit. It builds the hand-written kernels from ``csrc/`` (B1,
the banded Cholesky solve with its bare and its fused, refined entry, and
B2, the fused beam search of the cone sorter), holds each against its plain
PyTorch version on the card at the shapes the main path gives it, and
drives the trackdrive main path: ``batched_step`` at B = 256 on perturbed
corridors (with B1's fused entry and, for comparison, with the composition
of bare solves it replaces; with B2 and with the sorter's scan), then the
committed 300-frame session through ``PathPlanner`` without and with the
sorting cache. B2's K = 16 instantiation (the plan server's beam-width
knob) is held against its plain version too. B1's two
entries are also held against their plain versions on the systems the
relocalizer missions and the global-path branch give them (B = 256 and
B = 1, up to 704 input points and 1,024 dense samples, and the hairpin
frames on which a float32 factorization breaks down: the same inf and NaN
as the plain version). Then the relocalizer missions: the seeded skidpad
(full and partial view), acceleration and EBS sessions through
``PathPlanner`` against the JAX package's golden paths (on the frames where
that package falls back to its previous path, against its paths with a
float64 solver), ``batched_step`` at B = 256 on skidpad and on
acceleration frames each under its own SE(2) against the same batch on the
CPU, and trackdrive with a global path set and unset against the CPU.
Then the port's front doors: the C++ session loader (built with g++,
against its Python engine), ``bench_torch.py`` in-process at reduced depth
(its JSON line; its ``replay_scan`` over all 300 frames must give the
facade replay's paths), the replay CLI as a subprocess with and without
colour, the plan server on 127.0.0.1 (fixtures against a direct
``PathPlanner``, state carried across requests, the knobs that pick B2's
other instantiations and one that picks the sorter's scan, a malformed
request) and the viewer export. B2 is held against its plain version at
every instantiation: the sorter's default (32, 12, 5) and the general ones
of beam width 8, 16, 32 and 64, at (8, 8, 5), (16, 12, 5), (64, 16, 5) and
(32, 32, 7); the sort cache's hit sequence over the session is compared
with the JAX package's frame by frame. Then the sharded step against
``batched_step`` on a one-rank NCCL group and on two gloo ranks in two
processes on this card, ``dryrun_multichip(2)`` at ``large_map_config``, a
short ``profile_device`` run and the stage viewer's data half.
``--kernels-only`` stops after the kernels' own phases. It checks the
trackdrive paths against the reference planner's golden paths, and prints
one JSON line of kernel measurements and, last, one JSON line with the
device. Any failed phase ends the run with a non-zero exit
code and no result line. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
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
MISSIONS_GOLDEN = ROOT / "ft_fsd_path_planning_torch/assets/missions_golden.npz"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32 outside
# the tensor cores, the rate of the kernel's scalar arithmetic
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

BATCH, N_CONES = 256, 128  # the batch-throughput size
REPLAY_N_CONES = 256  # the session flattens to 138 cones
B2_FLOAT_TOL = 1e-6  # B2 vs plain version, float feature rows, absolute (integer-coded rows: equal)
SESSION_CAPTURE_FRAMES = (0, 75, 150, 225)  # session frames whose searches B2 is checked on
B1_EXACT_TOL = 0.0  # B1's entries keep every entry's summation order: equal bit for bit
FUSED_F64_REL_TOL = 1e-5  # fused entry vs float64 solve on well-conditioned synthetic systems
LATERAL_TOL = 0.01  # kernel path vs plain-solve path, metres
FUSED_LATERAL_TOL = 0.0  # fused entry vs the composition of bare solves it replaces, metres
AB_ROUNDS = 15  # steps of each kind when two versions of batched_step are timed in turns
SIMILAR_THRESHOLD = 0.1  # the sort cache's cone-distance threshold, metres
GOLDEN_MAX, GOLDEN_MEDIAN = 0.05, 0.01  # replay vs the reference planner, metres
MISSION_ROT_TOL, MISSION_TRANS_TOL = 1e-4, 1e-3  # relocalization_info vs the JAX package's, rad and metres
# a batch lane's rotation vs the SE(2) its frame was generated under, rad:
# what 0.02 m of cone noise leaves of it (skidpad: two median centres 18 m
# apart from as few as three circles; acceleration: a line through a row)
BATCH_ROT_TOL = {"skidpad": 2e-2, "acceleration": 1e-3}
TIME_LIMIT_S = 1200  # what the whole run, the kernels' build included, must stay inside
# B2's other shapes (beam_width, max_length, max_n_neighbors), one a general
# instantiation: the tiny configuration of the distributed tests, the plan
# server's beam width 16, beam width 64 at max length 16, and the bounds of
# the run-time max length and neighbour count
B2_SHAPES = ((8, 8, 5), (16, 12, 5), (64, 16, 5), (32, 32, 7))
B2_DEFAULT_MS = 0.1309  # B2 at (32, 12, 5), G = 512 from a CUDA graph before L and C became run-time values (the top of its range)
B2_DEFAULT_GROWTH = 1.10  # how much slower the exact default instantiation may have become
SORT_CACHE_GOLDEN = ROOT / "ft_fsd_path_planning_torch/assets/sort_cache_golden.npz"
# session frames whose largest cone distance lies within 1 mm of the sort
# cache's 0.1 m threshold (hits 18 ... 247, misses 211, 243, 293): a build may
# flip these and no others against the JAX package's hit sequence
SORT_CACHE_NEAR_THRESHOLD = (18, 58, 129, 199, 206, 211, 227, 243, 247, 293)
SHARDED_LATERAL_TOL = 0.01  # sharded step vs batched_step, metres
METRICS_REL_TOL = 1e-5  # reduced metrics (sum / count) vs batch_metrics (mean)
# the plan server's knobs that pick another B2 instantiation, and beam width
# 10, which the kernel does not take (the sorter's scan runs)
SERVE_KERNEL_KNOBS = ({"beam_width": 8}, {"beam_width": 64}, {"max_length": 8}, {"max_length": 16})
SERVE_SCAN_KNOB = {"beam_width": 10}
START = time.perf_counter()
BROKEN_FACTORIZATION_FRAMES = (20, 22)  # acceleration session frames whose hairpin fit breaks a float32 factorization down
BATCH_ROT_32_64_TOL = 1e-3  # the float32 step's rotation vs the same attempt in float64 on the same lane, rad


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


def graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` calls captured into one
    CUDA graph and replayed: the host's time per call (the Python wrapper,
    ctypes) is outside the measurement, the device's gap between two
    launches inside it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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


def read_counts(path: str, sorts: bool = True) -> dict:
    """Launches of both kernels since reset_counts(); every kernel of the
    path just driven must have been launched by it. A relocalizer mission
    does not sort (``sorts=False``): B2 is no kernel of that path and must
    not have been launched."""
    from ft_fsd_path_planning_torch.ops import banded_cholesky as bc
    from ft_fsd_path_planning_torch.ops import beam_search as bs

    counts = {"B1": bc.launch_count, "B2": bs.launch_count}
    check(counts["B1"] > 0, f"{path} did not launch B1")
    if sorts:
        check(counts["B2"] > 0, f"{path} did not launch B2")
    else:
        check(counts["B2"] == 0, f"{path} launched B2 {counts['B2']} times, and a relocalizer mission does not sort")
    check(bc.launch_count == bc.bare_launch_count + bc.refined_launch_count, "B1's counts do not add up")
    counts["B1 fused entry"] = bc.refined_launch_count
    counts["B1 bare entry"] = bc.bare_launch_count
    return counts


@contextlib.contextmanager
def env(**values: str):
    """Set environment variables inside the block."""
    before = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


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


def spd_band_systems(rng, b: int, c: int, r: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(dense (b, c, c), rhs (b, c, r)) of random SPD systems of half-bandwidth 4."""
    low = np.zeros((b, c, c))
    for off in range(5):
        idx = np.arange(c - off)
        low[:, idx + off, idx] = rng.normal(size=(b, c - off)) * (1.0 if off == 0 else 0.3)
    dense = low @ np.transpose(low, (0, 2, 1)) + np.eye(c) * 0.5
    dense = torch.tensor(dense, dtype=torch.float32, device=device)
    rhs = torch.tensor(rng.normal(size=(b, c, r)), dtype=torch.float32, device=device)
    return dense, rhs


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


def capture_refined_solves(run) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Call ``run()`` and keep the (dense matrix, rhs) of every refined solve
    the spline engine asks for meanwhile, in call order."""
    from ft_fsd_path_planning_torch.ops import spline

    seen: list[tuple[torch.Tensor, torch.Tensor]] = []
    original = spline.banded_refined_solve_cuda

    def recording(a, rhs):
        seen.append((a.clone(), rhs.clone()))
        return original(a, rhs)

    spline.banded_refined_solve_cuda = recording
    try:
        run()
        torch.cuda.synchronize()
    finally:
        spline.banded_refined_solve_cuda = original
    return seen


def capture_main_path_solves(cfg, dev) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The refined solves of one trackdrive batched step."""
    from ft_fsd_path_planning_torch.parallel import batch, scenarios

    frames = scenarios.make_frame_batch(cfg, BATCH, seed=1, device=dev)
    seen = capture_refined_solves(lambda: batch.batched_step(cfg, batch.make_batch_state(cfg, BATCH, dev), frames))
    log(f"main-path refined solves, shapes (B, C, R): {dict(Counter(tuple(rhs.shape) for _, rhs in seen))}")
    check(bool(seen), "the batched step never reached the banded solve")
    return seen


def rel_err_f64(x: torch.Tensor, dense: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Per system, max |x - x64| / max |x64| against a float64 dense solve."""
    want = torch.linalg.solve(dense.double(), rhs.double())
    scale = want.abs().amax(dim=(1, 2)).clamp(min=1e-30)
    return (x.double() - want).abs().amax(dim=(1, 2)) / scale


def phase_b1_vs_plain(cfg, dev) -> list[dict]:
    """Both entries of B1 against their plain versions: on every system a
    batched step hands the spline engine, on a synthetic (256, 28, 2) and on
    the two test shapes; the fused entry also through a strided view and
    against a float64 solve. Then the times of both entries at the main
    path's shape beside the empty launch, the composition the fused entry
    replaces, the plain versions and torch.linalg.solve."""
    from ft_fsd_path_planning_torch.ops import banded_cholesky as bc
    from ft_fsd_path_planning_torch.ops import spline

    rng = np.random.default_rng(0)
    captured = capture_main_path_solves(cfg, dev)
    cases = [(f"main path solve {i}", a, rhs) for i, (a, rhs) in enumerate(captured)]
    for shape in ((256, 28, 2), (7, 51, 2), (3, 20, 1)):
        cases.append((f"synthetic {shape}", *spd_band_systems(rng, *shape, dev)))
    dense_t = cases[-3][1].transpose(1, 2)  # the same symmetric systems, read through other strides
    cases.append(("synthetic (256, 28, 2), transposed view", dense_t, cases[-3][2]))

    bare_err = fused_err = 0.0
    bare_f64, fused_f64, main_err = [], [], [0.0, 0.0]
    for label, dense, rhs in cases:
        band = bc.dense_to_band(dense).contiguous()
        got_bare = bc.banded_cholesky_solve_cuda(band, rhs)
        got_fused = bc.banded_refined_solve_cuda(dense, rhs)
        torch.cuda.synchronize()
        want_bare = bc.banded_cholesky_solve_plain(band, rhs)
        want_fused = bc.banded_refined_solve_plain(dense, rhs)
        e_bare = float((got_bare - want_bare).abs().max())
        e_fused = float((got_fused - want_fused).abs().max())
        r_bare, r_fused = rel_err_f64(got_bare, dense, rhs), rel_err_f64(got_fused, dense, rhs)
        if label.startswith("main path"):
            bare_f64.append(r_bare)
            fused_f64.append(r_fused)
            main_err = [max(main_err[0], e_bare), max(main_err[1], e_fused)]
        else:
            check(float(r_fused.max()) <= FUSED_F64_REL_TOL, f"fused entry is off the float64 solve ({label}): {float(r_fused.max())}")
            log(
                f"B1 {label} {tuple(rhs.shape)}: max|kernel - plain| bare {e_bare!r}, fused {e_fused!r}; "
                f"vs float64 solve, relative: bare median {float(r_bare.median())!r} max {float(r_bare.max())!r}, "
                f"fused median {float(r_fused.median())!r} max {float(r_fused.max())!r}"
            )
        check(bool(torch.isfinite(got_bare).all() and torch.isfinite(got_fused).all()), f"B1 gave non-finite values ({label})")
        check(e_bare <= B1_EXACT_TOL, f"B1's bare entry disagrees with its plain version ({label}): {e_bare}")
        check(e_fused <= B1_EXACT_TOL, f"B1's fused entry disagrees with its plain version ({label}): {e_fused}")
        bare_err, fused_err = max(bare_err, e_bare), max(fused_err, e_fused)
    n_main = len(bare_f64)
    bare_f64, fused_f64 = torch.cat(bare_f64), torch.cat(fused_f64)
    log(
        f"B1 on the {n_main} main-path solves ({bare_f64.numel()} systems): max|kernel - plain| bare "
        f"{main_err[0]!r}, fused {main_err[1]!r}; relative error vs float64: "
        f"bare median {float(bare_f64.median())!r} max {float(bare_f64.max())!r}; "
        f"fused median {float(fused_f64.median())!r} max {float(fused_f64.max())!r}"
    )
    check(float(fused_f64.median()) <= float(bare_f64.median()), "the refinement round does not improve the solve")

    # timing at the main path's most frequent shape
    shapes = Counter(tuple(rhs.shape) for _, rhs in captured)
    dense, rhs = next(c for c in captured if tuple(c[1].shape) == shapes.most_common(1)[0][0])
    band = bc.dense_to_band(dense).contiguous()
    b, c, r = rhs.shape
    composition = lambda: spline._banded_solve(bc.dense_to_band(dense).contiguous(), rhs)  # noqa: E731
    bare, fused, empty = (
        lambda: bc.banded_cholesky_solve_cuda(band, rhs),
        lambda: bc.banded_refined_solve_cuda(dense, rhs),
        lambda: bc.empty_launch_cuda(b, dev),
    )
    # launched from Python one by one (what a caller sees; the host's time per
    # call bounds it from below), then replayed from a CUDA graph (the device's)
    eager = {"bare": cuda_ms(bare, 200), "fused": cuda_ms(fused, 200), "empty": cuda_ms(empty, 200)}
    ms, fused_ms, empty_ms = graph_ms(bare, 200), graph_ms(fused, 200), graph_ms(empty, 200)
    composition_ms, composition_graph_ms = cuda_ms(composition, 20), graph_ms(composition, 20)
    log(
        f"B1 launched one by one from Python at {tuple(rhs.shape)}: bare {eager['bare']!r} ms, fused {eager['fused']!r} ms, "
        f"empty kernel {eager['empty']!r} ms; replayed from a CUDA graph: bare {ms!r} ms, fused {fused_ms!r} ms, empty kernel {empty_ms!r} ms"
    )
    plain_ms = cuda_ms(lambda: bc.banded_cholesky_solve_plain(band, rhs), 10)
    fused_plain_ms = cuda_ms(lambda: bc.banded_refined_solve_plain(dense, rhs), 5)
    library_ms = cuda_ms(lambda: torch.linalg.solve(dense, rhs), 50)
    nbytes = bc.solve_bytes(b, c, r)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    rows = []
    for name, entry_ms, entry_plain_ms, err, flops in (
        ("banded_cholesky_solve", ms, plain_ms, bare_err, b * bc.solve_flops(c, r)),
        ("banded_refined_solve", fused_ms, fused_plain_ms, fused_err, b * bc.refined_solve_flops(c, r)),
    ):
        ops_ms = flops / FP32_FLOP_PER_S * 1e3
        log(
            f"B1 {name} at {(b, c, r)}: kernel {entry_ms!r} ms, plain {entry_plain_ms!r} ms, "
            f"torch.linalg.solve {library_ms!r} ms, bound {max(bytes_ms, ops_ms)!r} ms "
            f"({nbytes} B, {flops} flop), empty launch on the same grid {empty_ms!r} ms (kernel and empty launch from a CUDA graph)"
        )
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "ft_fsd_path_planning_torch/csrc/banded_cholesky.cu",
            "replaces": "ft_fsd_path_planning_tpu/ops/pallas/banded_cholesky.py:36",
            "launches": None,
            "max_abs_err": err,
            "ms": entry_ms,
            "plain_ms": entry_plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
            "empty_launch_ms": empty_ms,
            "timed": "CUDA graph replay of 200 launches; plain_ms and library_ms launched one by one",
            "one_by_one_ms": eager["bare" if name == "banded_cholesky_solve" else "fused"],
            "one_by_one_empty_launch_ms": eager["empty"],
        })
    log(
        "B1 the composition the fused entry replaces (dense_to_band, two bare solves, band_matvec, difference, sum): "
        f"one by one {composition_ms!r} ms, from a CUDA graph {composition_graph_ms!r} ms"
    )
    rows[1]["composition_ms"] = composition_graph_ms
    rows[1]["one_by_one_composition_ms"] = composition_ms
    return rows


def same_values(got: torch.Tensor, want: torch.Tensor) -> tuple[float, bool]:
    """(max |got - want| over the entries finite in both, whether the two
    hold NaN, +inf and -inf at the same entries)."""
    finite = torch.isfinite(got) & torch.isfinite(want)
    err = float((got - want)[finite].abs().max()) if bool(finite.any()) else 0.0
    same = bool(
        torch.equal(torch.isnan(got), torch.isnan(want))
        and torch.equal(torch.isposinf(got), torch.isposinf(want))
        and torch.equal(torch.isneginf(got), torch.isneginf(want))
    )
    return err, same


def broken_cpu_solves(mission, cfg, frames, picks) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Drive frame 0 and the frames ``picks`` through PathPlanner on the CPU
    and keep the (dense matrix, rhs) of every solve of the spline engine
    whose result is not finite."""
    from ft_fsd_path_planning_torch import PathPlanner
    from ft_fsd_path_planning_torch.ops import fitpack

    seen: list[tuple[torch.Tensor, torch.Tensor]] = []
    original = fitpack._solve_spd_banded

    def recording(a, rhs):
        x = original(a, rhs)
        if not bool(torch.isfinite(x).all()):
            seen.append((a.clone(), rhs.clone()))
        return x

    planner = PathPlanner(mission, config=cfg, device="cpu")
    fitpack._solve_spd_banded = recording
    try:
        for i in (0,) + tuple(picks):
            planner.calculate_path_in_global_frame(*frames[i])
    finally:
        fitpack._solve_spd_banded = original
    return seen


def phase_b1_vs_plain_missions(dev) -> None:
    """Both entries of B1 against their plain versions on the systems the
    relocalizer missions and the global-path branch hand the spline engine:
    a skidpad and an acceleration batched step at B = 256 from a fresh
    state; single frames at B = 1 through PathPlanner (two skidpad frames,
    acceleration frames 0, 20 and 22, a trackdrive frame with a global path
    set); every solve of the acceleration session that is not finite on the
    card. On the hairpin of that session a float32 factorization can break
    down (a pivot cancels to <= 0, the solve overflows to inf and NaN) and
    the p-iteration's retry depends on the kernel being non-finite exactly
    where the plain version is. Whether a given frame breaks depends on the
    last bits of the assembled matrix, so three more sets make sure of it:
    the systems that break on the host's CPU on frames 20 and 22, and
    synthetic band systems with a negative pivot. Equal on the finite
    entries, and NaN, +inf and -inf at the same entries."""
    from ft_fsd_path_planning_torch import MissionTypes, PathPlanner
    from ft_fsd_path_planning_torch.config import default_config
    from ft_fsd_path_planning_torch.ops import banded_cholesky as bc
    from ft_fsd_path_planning_torch.parallel import batch, scenarios

    def config(mission):
        return default_config(mission, n_cones=N_CONES)

    cases: list[tuple[str, list, bool]] = []  # (label, solves, must hold a non-finite solve)
    for mission_name in ("skidpad", "acceleration"):
        cfg = config(getattr(MissionTypes, mission_name))
        frames, _ = scenarios.mission_frame_batch(cfg, BATCH, seed=0, device=dev)
        state = batch.make_batch_state(cfg, BATCH, dev)
        cases.append((f"{mission_name} batched_step B={BATCH}", capture_refined_solves(lambda: batch.batched_step(cfg, state, frames)), False))

    sessions = scenarios.mission_sessions()
    frames = sessions["skidpad"][1]
    planner = PathPlanner(MissionTypes.skidpad, config=config(MissionTypes.skidpad), device=dev)
    for i in (0, 1):
        cases.append((f"skidpad frame {i} B=1", capture_refined_solves(lambda: planner.calculate_path_in_global_frame(*frames[i])), False))

    frames = sessions["acceleration"][1]
    accel = MissionTypes.acceleration
    planner = PathPlanner(accel, config=config(accel), device=dev)
    broke_on_card, broken_frames = [], []
    for i in range(len(frames)):
        solves = capture_refined_solves(lambda: planner.calculate_path_in_global_frame(*frames[i]))
        check(bool(solves), f"acceleration frame {i} never reached the banded solve")
        flags = torch.stack([~torch.isfinite(bc.banded_refined_solve_cuda(a, rhs)).all() for a, rhs in solves]).tolist()
        if any(flags):
            broken_frames.append(i)
        if i in (0,) + BROKEN_FACTORIZATION_FRAMES:
            cases.append((f"acceleration frame {i} B=1", solves, False))
        else:
            broke_on_card += [solve for solve, flag in zip(solves, flags) if flag]
    log(f"acceleration session on the card: frames with a solve that is not finite {broken_frames}")
    if broke_on_card:
        cases.append(("the other acceleration frames' solves that are not finite on the card", broke_on_card, True))

    planner = PathPlanner(MissionTypes.trackdrive, config=config(MissionTypes.trackdrive), device=dev)
    planner.set_global_path(scenarios.global_path_circle())
    frame = scenarios.corridor_session(1)[0]
    cases.append(("trackdrive frame with the global path set B=1", capture_refined_solves(lambda: planner.calculate_path_in_global_frame(*frame)), False))

    on_cpu = broken_cpu_solves(accel, config(accel), frames, BROKEN_FACTORIZATION_FRAMES)
    log(f"acceleration frames {BROKEN_FACTORIZATION_FRAMES} on the host's CPU: {len(on_cpu)} solves that are not finite")
    if on_cpu:
        cases.append(("the solves of those frames that are not finite on the CPU, on the card", [(a.to(dev), rhs.to(dev)) for a, rhs in on_cpu], False))
    # SPD band systems with one diagonal entry lowered until its pivot is negative
    rng = np.random.default_rng(2)
    synthetic = []
    for shape, row in (((256, 28, 2), 9), ((7, 51, 2), 0), ((3, 20, 1), 17)):
        dense, rhs = spd_band_systems(rng, *shape, dev)
        dense[:, row, row] -= 2.0 * dense[:, row, row].abs()
        synthetic.append((dense, rhs))
    cases.append(("synthetic systems with a negative pivot", synthetic, True))

    for label, solves, must_break in cases:
        check(bool(solves), f"{label} never reached the banded solve")
        bare_err = fused_err = 0.0
        broken = 0
        for i, (dense, rhs) in enumerate(solves):
            band = bc.dense_to_band(dense).contiguous()
            got_bare = bc.banded_cholesky_solve_cuda(band, rhs)
            got_fused = bc.banded_refined_solve_cuda(dense, rhs)
            torch.cuda.synchronize()
            e_bare, same_bare = same_values(got_bare, bc.banded_cholesky_solve_plain(band, rhs))
            e_fused, same_fused = same_values(got_fused, bc.banded_refined_solve_plain(dense, rhs))
            check(same_bare and same_fused, f"B1 and its plain version are non-finite at different entries ({label}, solve {i})")
            check(e_bare <= B1_EXACT_TOL, f"B1's bare entry disagrees with its plain version ({label}, solve {i}): {e_bare}")
            check(e_fused <= B1_EXACT_TOL, f"B1's fused entry disagrees with its plain version ({label}, solve {i}): {e_fused}")
            bare_err, fused_err = max(bare_err, e_bare), max(fused_err, e_fused)
            broken += int((~torch.isfinite(got_fused)).flatten(1).any(dim=1).sum())
        log(
            f"B1 on the {len(solves)} refined solves of {label}, shapes (B, C, R) {dict(Counter(tuple(rhs.shape) for _, rhs in solves))}: "
            f"max|kernel - plain| on the finite entries bare {bare_err!r}, fused {fused_err!r}; non-finite entries the same; "
            f"systems whose fused solve is not finite {broken}"
        )
        check(broken > 0 or not must_break, f"{label}: every solve is finite, so the non-finite entries were not compared")


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
    # the plan server's beam-width knob: the kernel's K = 16 instantiation
    narrow = dataclasses.replace(cfg, sorting=dataclasses.replace(cfg.sorting, beam_width=16))
    frames16 = scenarios.make_frame_batch(narrow, 37, seed=5, device=dev)
    cases.append((
        "beam width 16, seeded batch B=37",
        *capture_searches(lambda: batch.batched_step(narrow, batch.make_batch_state(narrow, 37, dev), frames16)),
    ))
    check(cases[-1][2]["k"] == 16, "the beam-width-16 search did not run at K = 16")

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
    eager_ms = cuda_ms(lambda: bs.fused_beam_search_cuda(*args, **kwargs), 100)
    ms = graph_ms(lambda: bs.fused_beam_search_cuda(*args, **kwargs), 100)
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
        f"B2 timing at G={g} N={n} K={k} L={l} C={c}: kernel {ms!r} ms from a CUDA graph "
        f"({eager_ms!r} ms launched one by one from Python), plain {plain_ms!r} ms, "
        f"the sorter's scan (the repo's other implementation, eager PyTorch) {scan_ms!r} ms, "
        f"bound {max(bytes_ms, ops_ms)!r} ms ({nbytes} B -> {bytes_ms!r} ms, {flops} flop -> {ops_ms!r} ms); "
        "no PyTorch call computes this function"
    )
    log(
        f"B2's exact default instantiation: {ms!r} ms at G={g}, against {B2_DEFAULT_MS} ms before L and C became "
        f"run-time values (the bar: {B2_DEFAULT_GROWTH} times that)"
    )
    check(ms <= B2_DEFAULT_MS * B2_DEFAULT_GROWTH, f"B2 at the default shape grew to {ms} ms")
    _, args1, kwargs1 = cases[1]
    eager_ms1 = cuda_ms(lambda: bs.fused_beam_search_cuda(*args1, **kwargs1), 100)
    ms1 = graph_ms(lambda: bs.fused_beam_search_cuda(*args1, **kwargs1), 100)
    log(
        f"B2 timing at G={args1[0].shape[0]} N={args1[0].shape[1]} (one frame of the replay): kernel {ms1!r} ms "
        f"from a CUDA graph ({eager_ms1!r} ms launched one by one)"
    )
    _, args16, kwargs16 = cases[-1]
    ms16 = graph_ms(lambda: bs.fused_beam_search_cuda(*args16, **kwargs16), 100)
    log(f"B2 timing at K=16 G={args16[0].shape[0]} N={args16[0].shape[1]}: kernel {ms16!r} ms from a CUDA graph")
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
        "k16_g74_ms": ms16,
        "timed": "CUDA graph replay of 100 launches; plain_ms and scan_ms launched one by one",
        "one_by_one_ms": eager_ms,
        "one_by_one_one_frame_ms": eager_ms1,
    }


def phase_b2_shapes(cfg, dev) -> list[dict]:
    """B2 at the shapes of B2_SHAPES: the searches of one batched_step at
    B = 256 with the sorter at that shape are captured, the kernel held
    against its plain version (every row and alive equal bit for bit) and
    timed from a CUDA graph beside its bound and the plain version."""
    from ft_fsd_path_planning_torch.ops import beam_search as bs
    from ft_fsd_path_planning_torch.parallel import batch, scenarios

    rows = []
    for k, l, c in B2_SHAPES:
        shaped = dataclasses.replace(
            cfg, sorting=dataclasses.replace(cfg.sorting, beam_width=k, max_length=l, max_n_neighbors=c)
        )
        frames = scenarios.make_frame_batch(shaped, BATCH, seed=1, device=dev)
        args, kwargs = capture_searches(
            lambda: batch.batched_step(shaped, batch.make_batch_state(shaped, BATCH, dev), frames)  # noqa: B023
        )
        check((kwargs["k"], kwargs["l"], kwargs["c"]) == (k, l, c), f"the sorter searched at {kwargs}, not {(k, l, c)}")
        got_f, got_a = bs.fused_beam_search_cuda(*args, **kwargs)
        torch.cuda.synchronize()
        want_f, want_a = bs.fused_beam_search_plain(*args, **kwargs)
        err, same = same_values(got_f, want_f)
        alive_equal = bool(torch.equal(got_a, want_a))
        g, n = args[0].shape[:2]
        ms = graph_ms(lambda: bs.fused_beam_search_cuda(*args, **kwargs), 100)  # noqa: B023
        plain_ms = cuda_ms(lambda: bs.fused_beam_search_plain(*args, **kwargs), 3)  # noqa: B023
        nbytes = bs.search_bytes(g, n, k, l, c)
        flops = g * bs.search_flops(n, k, l, c)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
        log(
            f"B2 {bs.instantiation(k, l, c)} at (K, L, C) = {(k, l, c)}, G={g} N={n}: max|kernel - plain| {err!r} "
            f"(non-finite entries the same {same}), alive equal {alive_equal} ({int(got_a.sum())} survivors); "
            f"{ms!r} ms from a CUDA graph, plain {plain_ms!r} ms, bound {max(bytes_ms, ops_ms)!r} ms "
            f"({nbytes} B -> {bytes_ms!r} ms, {flops} flop -> {ops_ms!r} ms)"
        )
        check(same and err == 0.0 and alive_equal, f"B2 disagrees with its plain version at {(k, l, c)}: {err}")
        rows.append({
            "name": f"fused_beam_search {bs.instantiation(k, l, c)}",
            "route": "cuda",
            "source": "ft_fsd_path_planning_torch/csrc/beam_search.cu",
            "replaces": "ft_fsd_path_planning_tpu/ops/pallas/beam_search.py:108",
            "shape": [k, l, c],
            "launches": None,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "timed": f"CUDA graph replay of 100 launches at G={g}, N={n}; plain_ms launched one by one",
        })
    return rows


def step_ms(step, reps: int) -> float:
    """Host-clock ms per call over ``reps`` calls, after the caller's warm-up."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def time_step(step) -> tuple[float, int]:
    """(ms per call over 5 calls, host syncs of one call)."""
    syncs = count_syncs(step)
    return step_ms(step, 5), syncs


def kernel_count(step) -> int:
    """Device kernels one call of ``step`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


def phase_batched_step(cfg, dev) -> dict:
    """batched_step at B = 256: counted run, timing, then the same batch with
    the composition of bare solves in place of B1's fused entry, with the
    plain solve forced and with the sorter's scan in place of B2, compared.
    Returns the kernels' launches in one step."""
    from ft_fsd_path_planning_torch.ops import banded_cholesky as bc
    from ft_fsd_path_planning_torch.ops import beam_search as bs
    from ft_fsd_path_planning_torch.ops import fitpack, spline
    from ft_fsd_path_planning_torch.parallel import batch, scenarios

    frames = scenarios.make_frame_batch(cfg, BATCH, seed=0, device=dev)
    state = batch.make_batch_state(cfg, BATCH, dev)
    step = lambda: batch.batched_step(cfg, state, frames)  # noqa: E731

    solves = 0
    solve_spd_banded = fitpack._solve_spd_banded

    def counting(a, b):
        nonlocal solves
        solves += 1
        return solve_spd_banded(a, b)

    reset_counts()
    fitpack.loop_syncs = 0
    fitpack._solve_spd_banded = counting
    try:
        out, _ = step()
        torch.cuda.synchronize()
    finally:
        fitpack._solve_spd_banded = solve_spd_banded
    launches, loop_syncs = read_counts("batched_step"), fitpack.loop_syncs
    log(
        f"batched_step B={BATCH}: launches {launches}, solves the spline engine asked for {solves}, "
        f"FITPACK loop-condition syncs {loop_syncs}"
    )
    check(launches["B1"] == solves, f"B1 launched {launches['B1']} times for {solves} solves: not one launch per solve")
    check(launches["B1 bare entry"] == 0, "the main path launched B1's bare entry")
    check(launches["B2"] == 1, f"B2 launched {launches['B2']} times in one step")
    check(out.path.shape == (BATCH, 40, 4), f"path shape {tuple(out.path.shape)}")
    check(bool(torch.isfinite(out.path).all()), "non-finite paths")
    metrics = batch.batch_metrics(out)
    log("metrics: " + json.dumps({k: float(v) for k, v in metrics._asdict().items()}))
    check(float(metrics.solve_success_rate) > 0.5, "most frames fell back to the previous path")

    b2_ms, syncs = time_step(step)
    log(f"batched_step B={BATCH} with B2: {b2_ms!r} ms/step, {BATCH / b2_ms * 1e3!r} frames/s, {syncs} host syncs/step")

    # the composition B1's fused entry replaces, on the kernel's bare entry:
    # same arithmetic, so the same paths; timed in turns within this call
    @contextlib.contextmanager
    def refined_solve(fn):
        spline.banded_refined_solve_cuda = fn
        try:
            yield
        finally:
            spline.banded_refined_solve_cuda = bc.banded_refined_solve_cuda

    def composition(a, rhs):
        return spline._banded_solve(bc.dense_to_band(a).contiguous(), rhs)

    with refined_solve(composition):
        reset_counts()
        comp_out, _ = step()
        torch.cuda.synchronize()
        comp_launches = bc.bare_launch_count
        comp_kernels = kernel_count(step)
    fused_kernels = kernel_count(step)
    # one step of each in turns, so that the host's drift falls on both alike
    fused_ms, comp_ms = [], []
    for _ in range(AB_ROUNDS):
        fused_ms.append(step_ms(step, 1))
        with refined_solve(composition):
            comp_ms.append(step_ms(step, 1))
    dev_m = lateral(out.path, comp_out.path)
    comp_metrics = batch.batch_metrics(comp_out)
    log(
        f"fused entry vs composition batched_step: max lateral {float(dev_m.max())!r} m, path_ok equal "
        f"{bool((out.path_ok == comp_out.path_ok).all())}, metrics equal "
        f"{all(float(a) == float(b) for a, b in zip(metrics, comp_metrics))}; B1 launches "
        f"{launches['B1']} vs {comp_launches}; device kernels/step {fused_kernels} vs {comp_kernels}; ms/step over "
        f"{AB_ROUNDS} steps of each in turns: fused median {float(np.median(fused_ms))!r} min {min(fused_ms)!r}, "
        f"composition median {float(np.median(comp_ms))!r} min {min(comp_ms)!r}"
    )
    check(comp_launches == 2 * solves, "the composition did not launch the bare entry twice per solve")
    check(float(dev_m.max()) <= FUSED_LATERAL_TOL, "fused-entry and composition paths differ")
    check(bool((out.path_ok == comp_out.path_ok).all()), "fused entry and composition disagree on path_ok")
    check(
        float(metrics.solve_success_rate) == float(comp_metrics.solve_success_rate)
        and float(metrics.spline_budget_hit_rate) == float(comp_metrics.spline_budget_hit_rate),
        "fused entry and composition disagree on solve_success_rate or spline_budget_hit_rate",
    )

    with refined_solve(bc.banded_refined_solve_plain):
        plain_out, _ = step()
        torch.cuda.synchronize()
    dev_m = lateral(out.path, plain_out.path)
    log(f"kernel vs plain-solve batched_step: max lateral {float(dev_m.max())!r} m, path_ok equal {bool((out.path_ok == plain_out.path_ok).all())}")
    check(float(dev_m.max()) < LATERAL_TOL, "kernel and plain-solve paths differ")

    with env(FT_FSD_FUSED_BEAM="0"):  # the sorter's scan in place of B2
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


def replay_facade(planner, args, golden, label: str) -> tuple[np.ndarray, dict, list[bool]]:
    """Drive the session through ``planner``; check shape, finiteness and the
    golden bars; returns (paths, both kernels' launches, whether each frame
    hit the sort cache)."""
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
    return paths, launches, list(hit)


@contextlib.contextmanager
def similarity_log():
    """Record every similarity test the sort cache makes inside the block:
    (frame, largest distance of a cone to its nearest counterpart in the
    previous frame in metres, or None where the arrays differ in shape or
    there is no previous frame, the test's verdict). A frame makes up to
    three tests (left start cones, right start cones, all cones) and stops
    at the first that fails."""
    from ft_fsd_path_planning_torch.models import facade

    original = facade._cone_arrays_are_similar
    calls: list[tuple[int, float | None, bool]] = []
    frame = -1

    def recording(a, b, threshold):
        verdict = original(a, b, threshold)
        dist = None
        if a is not None and b is not None and a.shape == b.shape and a.shape[0] > 0:
            d = np.sum((a[:, None, :2] - b[None, :, :2]) ** 2, axis=-1)
            dist = float(np.sqrt(d.min(axis=1).max()))
        calls.append((frame, dist, verdict))
        return verdict

    step = facade.PathPlanner._step_with_sort_cache

    def stepping(self, *a, **kw):
        nonlocal frame
        frame += 1
        return step(self, *a, **kw)

    facade._cone_arrays_are_similar = recording
    facade.PathPlanner._step_with_sort_cache = stepping
    try:
        yield calls
    finally:
        facade._cone_arrays_are_similar = original
        facade.PathPlanner._step_with_sort_cache = step


def report_similarity(calls: list, n_frames: int) -> None:
    """Log the hit frames, each frame's largest cone distance beside the
    threshold, and the frames that sit within 1 mm of it."""
    per_frame = []
    for f in range(n_frames):
        mine = [(d, ok) for g, d, ok in calls if g == f]
        hit = len(mine) == 3 and all(ok for _, ok in mine)
        dists = [d for d, _ in mine if d is not None]
        per_frame.append((f, hit, max(dists) if dists else None))
    hits = [f for f, hit, _ in per_frame if hit]
    log(f"sort cache hit frames ({len(hits)}): {hits}")
    log(
        f"sort cache, per frame [frame, hit, largest cone distance in the tests made, m; threshold {SIMILAR_THRESHOLD}]: "
        + json.dumps([[f, int(hit), None if d is None else round(d, 6)] for f, hit, d in per_frame])
    )
    near = [(f, hit, d) for f, hit, d in per_frame if d is not None and abs(d - SIMILAR_THRESHOLD) < 1e-3]
    log(f"sort cache frames within 1 mm of the threshold: {[[f, int(hit), d] for f, hit, d in near]}")


def phase_replay(cfg, dev) -> tuple[dict, np.ndarray]:
    """The 300-frame session through PathPlanner (latency, golden parity)
    and through PathPlanner with the sorting cache. Returns both kernels'
    launches of the two facade replays and the first replay's paths, which
    the bench's ``replay_scan`` must give again (phase_bench)."""
    from ft_fsd_path_planning_torch import MissionTypes, PathPlanner

    golden = np.load(GOLDEN)
    args = session_args()

    warm = PathPlanner(MissionTypes.trackdrive, config=cfg, device=dev)
    warm.calculate_path_in_global_frame(*args[0])

    planner = PathPlanner(MissionTypes.trackdrive, config=cfg, device=dev)
    paths, launches, _ = replay_facade(planner, args, golden["paths_plain"], "PathPlanner replay")

    cached_cfg = dataclasses.replace(cfg, experimental_performance_improvements=True)
    cached = PathPlanner(MissionTypes.trackdrive, config=cached_cfg, device=dev)
    with similarity_log() as similarity:
        _, cached_launches, hits = replay_facade(cached, args, golden["paths_cached"], "PathPlanner replay with the sort cache")
    report_similarity(similarity, len(args))
    want = np.load(SORT_CACHE_GOLDEN)["hit"]
    differ = np.nonzero(np.asarray(hits) != want)[0].tolist()
    log(
        f"sort cache hit sequence vs the JAX package's ({SORT_CACHE_GOLDEN.name}, {int(want.sum())} hits): "
        f"{len(hits)} frames compared, frames that differ {differ}; allowed, within 1 mm of the threshold: "
        f"{list(SORT_CACHE_NEAR_THRESHOLD)}"
    )
    check(len(hits) == len(want), "the replay and the golden hit sequence differ in length")
    check(set(differ) <= set(SORT_CACHE_NEAR_THRESHOLD), f"the sort cache hit differently on frames {differ}")
    ref_hits, ref_checks = (int(x) for x in golden["ref_cache_hits"])
    log(
        f"sort cache: {cached.sort_cache_hits} of {len(args)} frames hit (both sides at once); "
        f"the reference planner hit {ref_hits} of {ref_checks} per-side checks"
    )
    check(cached.sort_cache_hits / len(args) > 0.2, "the sort cache did not engage")
    check(cached_launches["B2"] + cached.sort_cache_hits == len(args), "a cache miss did not launch B2 once")

    return {"replay": launches, "cached_replay": cached_launches}, paths


def timed(phase, *args):
    """Run one phase of the main path and log the wall time it took."""
    t0 = time.perf_counter()
    out = phase(*args)
    log(f"{phase.__name__}: {time.perf_counter() - t0!r} s")
    return out


def percentiles(ms: list[float]) -> str:
    if not ms:
        return "none"
    return f"p50 {float(np.percentile(ms, 50))!r} ms, p99 {float(np.percentile(ms, 99))!r} ms over {len(ms)} frames"


@contextlib.contextmanager
def recorded_path_ok():
    """Record ``path_ok`` of every step PathPlanner makes inside the block
    (as tensors on the device: no sync is added to the frame)."""
    from ft_fsd_path_planning_torch.models import facade

    oks: list[torch.Tensor] = []
    original = facade.planner_step

    def recording(*args, **kwargs):
        out, state = original(*args, **kwargs)
        oks.append(out.path_ok[0])
        return out, state

    facade.planner_step = recording
    try:
        yield oks
    finally:
        facade.planner_step = original


def phase_mission_replay(dev) -> dict:
    """The seeded mission sessions (skidpad with the full and the partial
    view, acceleration, EBS test) through PathPlanner on the card, against
    the JAX package's golden file: the same frame of first relocalization,
    relocalization_info, per-frame lateral deviation, the same frames solved
    afresh (``path_ok``). On a frame where the JAX package fell back to its
    previous path the port is held against the JAX package run with a
    float64 solver, which does not fall back there (the golden tool stores
    both). Returns per session both kernels' launches."""
    from ft_fsd_path_planning_torch import MissionTypes, PathPlanner
    from ft_fsd_path_planning_torch.config import default_config
    from ft_fsd_path_planning_torch.ops import banded_cholesky as bc
    from ft_fsd_path_planning_torch.parallel import scenarios

    golden = np.load(MISSIONS_GOLDEN)
    launches = {}
    for name, (mission_name, frames) in scenarios.mission_sessions().items():
        mission = getattr(MissionTypes, mission_name)
        cfg = default_config(mission, n_cones=N_CONES)
        warm = PathPlanner(mission, config=cfg, device=dev)
        warm.calculate_path_in_global_frame(*frames[0])  # warm-up: allocator, the relocalizers' tables

        planner = PathPlanner(mission, config=cfg, device=dev)
        reset_counts()
        paths, lat_ms, b1_frame, first = [], [], [], -1
        with recorded_path_ok() as oks:
            for i, a in enumerate(frames):
                before = bc.launch_count
                t0 = time.perf_counter()
                paths.append(planner.calculate_path_in_global_frame(*a))
                lat_ms.append((time.perf_counter() - t0) * 1e3)
                b1_frame.append(bc.launch_count - before)
                if first < 0 and planner.relocalization_info is not None:
                    first = i
        counts = read_counts(f"{name} replay", sorts=False)
        paths, path_ok = np.stack(paths), torch.stack(oks).cpu().numpy()
        want, want_ok = golden[f"{name}/paths"][: len(frames)].copy(), golden[f"{name}/path_ok"][: len(frames)].copy()
        theirs_fell_back = np.nonzero(~want_ok)[0]
        if len(theirs_fell_back):
            want[theirs_fell_back] = golden[f"{name}/paths_float64_solver"][theirs_fell_back]
            want_ok[theirs_fell_back] = golden[f"{name}/path_ok_float64_solver"][theirs_fell_back]
        check(paths.shape == want.shape and np.isfinite(paths).all(), f"bad mission paths ({name})")
        check(min(b1_frame) > 0, f"a {name} frame launched B1 no time")
        info = planner.relocalization_info
        check(info is not None, f"{name} never relocalized")
        rot_err = abs(info.rotation - float(golden[f"{name}/rotation"]))
        trans_err = float(np.abs(info.translation - golden[f"{name}/translation"]).max())
        devs = lateral(torch.tensor(paths), torch.tensor(want)).numpy()
        if len(theirs_fell_back):
            log(
                f"mission replay {name}: the JAX package fell back to its previous path on frames {theirs_fell_back.tolist()}; there the port is "
                f"held against the JAX package with a float64 solver: lateral {[float(devs[i]) for i in theirs_fell_back]!r} m, "
                f"path_ok there {want_ok[theirs_fell_back].tolist()}, the port's {path_ok[theirs_fell_back].tolist()}"
            )
        ours_fell_back = np.nonzero(~path_ok)[0].tolist()
        check(np.array_equal(path_ok, want_ok), f"{name}: the port fell back to its previous path on {ours_fell_back}, the golden file on {np.nonzero(~want_ok)[0].tolist()}")
        log(
            f"mission replay {name} ({mission_name}, n_cones {N_CONES}) {len(frames)} frames: first relocalized at frame {first} "
            f"(JAX package {int(golden[f'{name}/first_relocalized'])}), rotation {info.rotation!r} (off by {rot_err!r} rad), "
            f"translation {info.translation.tolist()} (off by {trans_err!r} m); lateral vs the JAX package's paths max "
            f"{float(devs.max())!r} m (frame {int(devs.argmax())}), median {float(np.median(devs))!r} m"
        )
        log(
            f"mission replay {name}: latency before relocalization {percentiles(lat_ms[:first])}; after {percentiles(lat_ms[first + 1:])}; "
            f"the relocalization frame with its float64 refinement {lat_ms[first]!r} ms; B1 launches a frame median "
            f"{int(np.median(b1_frame))} min {min(b1_frame)} max {max(b1_frame)} (relocalization frame {b1_frame[first]}), "
            f"all {counts['B1']}, through the fused entry {counts['B1 fused entry']}; B2 launches {counts['B2']}"
        )
        check(first == int(golden[f"{name}/first_relocalized"]), f"{name} relocalized on another frame than the JAX package")
        check(rot_err < MISSION_ROT_TOL, f"{name}: relocalization rotation off by {rot_err}")
        check(trans_err < MISSION_TRANS_TOL, f"{name}: relocalization translation off by {trans_err}")
        check(float(devs.max()) < LATERAL_TOL, f"{name}: paths deviate from the JAX package's by {float(devs.max())} m")
        check(counts["B1 bare entry"] == 0, f"{name} launched B1's bare entry")
        launches[name] = dict(counts, frames=len(frames), b1_per_frame=int(np.median(b1_frame)))
    return launches


def wrapped(angle: torch.Tensor) -> torch.Tensor:
    """The size of an angle once it is wrapped into [-pi, pi)."""
    return (torch.remainder(angle + np.pi, 2 * np.pi) - np.pi).abs()


def phase_mission_batched_step(dev) -> dict:
    """batched_step at B = 256 on skidpad and on acceleration frames, each
    lane under its own SE(2), twice from a fresh state (in the second step
    the relocalized lanes stay frozen), against the same batch on the CPU
    lane for lane and against the same attempt in float64 on the card.
    Returns per mission both kernels' launches of each step."""
    from ft_fsd_path_planning_torch import MissionTypes
    from ft_fsd_path_planning_torch.config import default_config
    from ft_fsd_path_planning_torch.models import relocalization
    from ft_fsd_path_planning_torch.models.planner import FrameInput
    from ft_fsd_path_planning_torch.ops import fitpack
    from ft_fsd_path_planning_torch.parallel import batch, scenarios

    launches = {}
    for mission_name in ("skidpad", "acceleration"):
        cfg = default_config(getattr(MissionTypes, mission_name), n_cones=N_CONES)
        frames, map_rotation = scenarios.mission_frame_batch(cfg, BATCH, seed=0, device=dev)
        fresh = batch.make_batch_state(cfg, BATCH, dev)
        batch.batched_step(cfg, fresh, frames)  # warm-up
        torch.cuda.synchronize()

        outs, counts, state = [], [], fresh
        for _ in range(2):
            reset_counts()
            fitpack.loop_syncs = 0
            out, state = batch.batched_step(cfg, state, frames)
            torch.cuda.synchronize()
            counts.append(dict(read_counts(f"{mission_name} batched_step", sorts=False), loop_syncs=fitpack.loop_syncs))
            outs.append((out, state))
        t0 = time.perf_counter()
        cpu_frames = FrameInput(*(x.cpu() for x in frames))
        cpu_outs, cpu_state = [], batch.make_batch_state(cfg, BATCH, "cpu")
        for _ in range(2):
            out, cpu_state = batch.batched_step(cfg, cpu_state, cpu_frames)
            cpu_outs.append((out, cpu_state))
        cpu_s = time.perf_counter() - t0

        (out1, st1), (out2, st2) = outs
        relocalized = out1.relocalized
        share = float(relocalized.float().mean())
        map_rotation = torch.as_tensor(map_rotation)
        rot_err = wrapped(st1.reloc.rotation.double().cpu() + map_rotation)[relocalized.cpu()]
        devs = [float(lateral(o.path.cpu(), c.path).max()) for (o, _), (c, _) in zip(outs, cpu_outs)]
        # the same attempt in float64 on the card, as the facade's refinement
        # runs it: the step's float32 transform must agree with it, and what
        # is left against a lane's own SE(2) is the cones' noise, the same in
        # either precision
        xy64, pos64, dir64 = (t.double() for t in (frames.cones[..., :2], frames.position, frames.direction))
        if mission_name == "skidpad":
            ok64, rot64, trans64, _ = relocalization.skidpad_relocalize_once(xy64, frames.mask, pos64, pos64, dir64)
        else:
            ok64, rot64, trans64, _ = relocalization.acceleration_relocalize_once(xy64, frames.mask, pos64, dir64, pos64)
        both = relocalized & ok64
        rot_32_64 = wrapped(st1.reloc.rotation.double() - rot64)[both]
        trans_32_64 = (st1.reloc.translation.double() - trans64).abs()[both]
        rot_err64 = wrapped(rot64.cpu() + map_rotation)[both.cpu()]
        log(
            f"mission batched_step {mission_name} B={BATCH}: the attempt in float64 on the card relocalizes {int(ok64.sum())} lanes "
            f"({int((ok64 != relocalized).sum())} other than the float32 step); float32 step vs float64 on the lanes of both: rotation max "
            f"{float(rot_32_64.max())!r} rad, translation max {float(trans_32_64.max())!r} m; float64 rotation vs the lanes' own SE(2) max "
            f"{float(rot_err64.max())!r} rad"
        )
        check(float(rot_32_64.max()) < BATCH_ROT_32_64_TOL, f"{mission_name}: the float32 step's rotation is off the float64 one by {float(rot_32_64.max())} rad")
        log(
            f"mission batched_step {mission_name} B={BATCH} (global window {cfg.shapes.global_window}, dense samples "
            f"{cfg.shapes.dense_samples}): relocalized share {share!r} (on the CPU {float(cpu_outs[0][0].relocalized.float().mean())!r}), "
            f"rotation vs the lanes' own SE(2) max {float(rot_err.max())!r} rad median {float(rot_err.median())!r} rad; "
            f"path_ok share {float(out1.path_ok.float().mean())!r}, {float(out2.path_ok.float().mean())!r}; "
            f"lateral card vs CPU, step 1 and 2: {devs!r} m (the CPU's two steps took {cpu_s!r} s)"
        )
        for step_no, ((out, st), (cpu_out, cpu_st)) in enumerate(zip(outs, cpu_outs), 1):
            check(out.path.shape == (BATCH, 40, 4) and bool(torch.isfinite(out.path).all()), f"bad {mission_name} batch paths")
            check(bool(torch.equal(out.relocalized.cpu(), cpu_out.relocalized)), f"{mission_name} step {step_no}: card and CPU relocalize different lanes")
            check(bool(torch.equal(out.path_ok.cpu(), cpu_out.path_ok)), f"{mission_name} step {step_no}: card and CPU disagree on path_ok")
        check(max(devs) < LATERAL_TOL, f"{mission_name}: card and CPU paths differ by {max(devs)} m")
        check(share > 0.1, f"{mission_name}: hardly a lane relocalized")
        check(float(rot_err.max()) < BATCH_ROT_TOL[mission_name], f"{mission_name}: a lane's rotation is off its SE(2) by {float(rot_err.max())} rad")
        for name in ("rotation", "translation", "center", "relocalized"):
            check(bool(torch.equal(getattr(st1.reloc, name), getattr(st2.reloc, name))), f"{mission_name}: {name} moved after relocalization")

        for label, start, count in (("from a fresh state", fresh, counts[0]), ("from the relocalized state", st1, counts[1])):
            step = lambda: batch.batched_step(cfg, start, frames)  # noqa: E731
            ms, syncs = time_step(step)
            log(
                f"mission batched_step {mission_name} B={BATCH} {label}: {ms!r} ms/step, {BATCH / ms * 1e3!r} frames/s, "
                f"{syncs} host syncs/step ({count['loop_syncs']} FITPACK loop conditions), {kernel_count(step)} device kernels/step, "
                f"launches {count}"
            )
        launches[mission_name] = {"fresh": counts[0], "relocalized": counts[1]}
    return launches


def phase_global_path(dev) -> dict:
    """Trackdrive with a circle set as the global path, then unset, on the
    same planner: the card's paths against the CPU's. Returns both kernels'
    launches with the path set and after it is unset."""
    from ft_fsd_path_planning_torch import MissionTypes, PathPlanner
    from ft_fsd_path_planning_torch.config import default_config
    from ft_fsd_path_planning_torch.parallel import scenarios

    frames = scenarios.corridor_session(8)
    circle = scenarios.global_path_circle()
    cfg = default_config(MissionTypes.trackdrive, n_cones=N_CONES)
    planners = [PathPlanner(MissionTypes.trackdrive, config=cfg, device=d) for d in (dev, "cpu")]
    launches, paths, lat_ms = {}, [], []
    for label, chunk, path in (("set", frames[:4], circle), ("unset", frames[4:], None)):
        for planner in planners:
            planner.set_global_path(path)
        reset_counts()
        for a in chunk:
            t0 = time.perf_counter()
            on_card = planners[0].calculate_path_in_global_frame(*a)
            lat_ms.append((time.perf_counter() - t0) * 1e3)
            paths.append((on_card, planners[1].calculate_path_in_global_frame(*a)))
        launches[label] = dict(read_counts(f"trackdrive with the global path {label}"), frames=len(chunk))
    card, cpu = (np.stack(x) for x in zip(*paths))
    check(np.isfinite(card).all(), "non-finite paths with a global path")
    devs = lateral(torch.tensor(card), torch.tensor(cpu)).numpy()
    bend = float(card[3, -1, 2] - frames[3][1][1])
    log(
        f"global path (circle of {len(circle)} points over a straight corridor, n_cones {N_CONES}): lateral card vs CPU per frame "
        f"{[float(d) for d in devs]!r} m; end of the path {bend!r} m to the left of the car with the circle set, "
        f"{float(card[-1, -1, 2])!r} m after it is unset; latency per frame {[round(m, 1) for m in lat_ms]} ms; launches {launches}"
    )
    check(float(devs.max()) < LATERAL_TOL, f"global path: card and CPU paths differ by {float(devs.max())} m")
    check(bend > 2.0 and abs(float(card[-1, -1, 2])) < 0.3, "the global path did not steer the path, or went on steering it after it was unset")
    check(planners[0].cfg.supports_global_path, "set_global_path did not switch the config")
    return launches


def phase_loader() -> None:
    """The port's C++ session loader, built with g++ here, against its
    Python engine on the committed session: the same arrays bit for bit."""
    from ft_fsd_path_planning_torch.native import loader

    t0 = time.perf_counter()
    lib = loader.build()
    log(f"C++ loader built in {time.perf_counter() - t0!r} s: {lib.relative_to(ROOT)}")
    for n_max in (REPLAY_N_CONES, N_CONES):
        t0 = time.perf_counter()
        cpp = loader.load_session(SESSION, n_max=n_max)
        cpp_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        python = loader.load_session(SESSION, n_max=n_max, engine="python")
        python_s = time.perf_counter() - t0
        same = all(a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes() for a, b in zip(cpp, python))
        log(
            f"session loader n_max={n_max}: {len(cpp[0])} frames, C++ {cpp_s * 1e3!r} ms, Python {python_s * 1e3!r} ms, "
            f"arrays equal bit for bit {same}"
        )
        check(same and len(cpp[0]) == 300, f"the C++ and Python loaders disagree at n_max={n_max}")


BENCH_KEYS = (
    "metric", "value", "unit", "vs_baseline", "latency_b1_device_ms", "latency_b1_p50_ms",
    "latency_b1_p99_ms", "link_rtt_floor_ms", "replay_solves_per_s", "replay_parity_dev_p95_m",
    "replay_parity_dev_max_m", "replay_centerline_dev_p95_m", "replay_centerline_dev_max_m",
    "large_map_256_solves_per_s", "device", "power_limit_w",
)


def phase_bench(dev, facade_paths: np.ndarray) -> dict:
    """bench_torch.py in-process at reduced depth: its JSON line with every
    key and every number finite and positive, replay parity within the
    golden bar, its replay_scan paths (all 300 frames) within 1 mm of the
    facade replay's. Returns the kernels' launches per batch step and over
    the whole run."""
    import bench_torch
    from ft_fsd_path_planning_torch.ops import banded_cholesky as bc
    from ft_fsd_path_planning_torch.ops import beam_search as bs

    steps: dict = {}
    original = bench_torch.batched_step

    def counting(cfg, states, frames):
        b1, b2 = bc.launch_count, bs.launch_count
        out = original(cfg, states, frames)
        key = f"B={frames.cones.shape[0]} n_cones={cfg.shapes.n_cones}"
        steps.setdefault(key, []).append((bc.launch_count - b1, bs.launch_count - b2))
        return out

    bench_torch.batched_step = counting
    try:
        with env(BENCH_ITERS="5", BENCH_LAT_FRAMES="30", BENCH_LARGE_BATCH="128", BENCH_REPLAY_ITERS="1"):
            reset_counts()
            line, paths = bench_torch.run(dev)
            total = read_counts("bench_torch")
    finally:
        bench_torch.batched_step = original
    log("bench_torch (BENCH_ITERS=5 BENCH_LAT_FRAMES=30 BENCH_LARGE_BATCH=128 BENCH_REPLAY_ITERS=1): " + json.dumps(line))
    check(set(line) == set(BENCH_KEYS), f"bench keys {sorted(line)}")
    for key in BENCH_KEYS:
        value = line[key]
        if isinstance(value, str):
            check(bool(value), f"bench {key} is empty")
        else:
            check(isinstance(value, (int, float)) and np.isfinite(value) and value > 0, f"bench {key} = {value!r}")
    check(line["replay_parity_dev_max_m"] < GOLDEN_MAX, f"bench replay parity max {line['replay_parity_dev_max_m']}")
    check(paths.shape == (300, 40, 4), f"bench replay paths {tuple(paths.shape)}")
    diff = lateral(paths, torch.tensor(facade_paths, device=dev))
    log(f"bench replay_scan 300 frames: max lateral vs the PathPlanner replay {float(diff.max())!r} m")
    check(float(diff.max()) < 1e-3, "bench_torch's replay_scan and PathPlanner disagree")
    per_step = {k: {"B1": sorted({a for a, _ in v}), "B2": sorted({b for _, b in v}), "steps": len(v)} for k, v in steps.items()}
    log(f"bench launches per batched_step (distinct values): {per_step}; whole run {total}")
    check(total["B1 bare entry"] == 0, "the bench launched B1's bare entry")
    return {"batch_step": per_step, "run": total}


DEMO_LINE = re.compile(r"frames: (\d+)  mean: (\S+) ms  p50: (\S+) ms  p99: (\S+) ms")


def phase_demo() -> dict:
    """The replay CLI as a user starts it, on the session with and without
    colour: exit 0, the frames line with the frames asked for and finite
    times, both kernels launched."""
    launches = {}
    for label, extra, frames in (("colour", [], 40), ("no colour", ["--remove-color-info"], 20)):
        cmd = [sys.executable, "-m", "ft_fsd_path_planning_torch.demo", str(SESSION), "--max-frames", str(frames), *extra]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        out = proc.stdout
        log(f"CLI ({label}) exit {proc.returncode} in {wall!r} s: " + " | ".join(out.strip().splitlines()))
        check(proc.returncode == 0, f"the CLI ({label}) failed:\n{proc.stderr[-4000:]}")
        match = DEMO_LINE.search(out)
        check(match is not None, f"no frames line from the CLI ({label})")
        times = [float(match.group(i)) for i in (2, 3, 4)]
        check(int(match.group(1)) == frames and all(np.isfinite(times)), f"CLI ({label}) frames line {match.group(0)}")
        counts = json.loads(out.split("kernel launches: ", 1)[1].splitlines()[0])
        check(counts["B1"] > 0 and counts["B2"] > 0, f"the CLI ({label}) did not launch both kernels: {counts}")
        launches[label] = counts
    return launches


def _request(url: str, body: bytes | None = None) -> tuple[int, object]:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST" if body is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            raw = r.read()
            return r.status, json.loads(raw) if r.headers.get_content_type() == "application/json" else raw
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def phase_serve(dev) -> dict:
    """The plan server in-process on 127.0.0.1 on the card: the page, the
    fixtures, /plan on every fixture against a direct PathPlanner on the
    card, session frames over two requests with the state carried, a new
    planner for beam width 16, a malformed request (500) and a good one
    after it (200). Returns the kernels' launches over the fixture
    requests."""
    import threading

    from ft_fsd_path_planning_torch import PathPlanner
    from ft_fsd_path_planning_torch.demo import serve
    from ft_fsd_path_planning_torch.ops import beam_search as bs

    knob_counts: dict = {}  # B2's launches by instantiation over the knob requests

    def direct(overrides: dict, frames: list) -> np.ndarray:
        cfg = serve._build_config(overrides)
        planner = PathPlanner(cfg.mission, config=cfg, device=dev)
        return np.stack([
            planner.calculate_path_in_global_frame(
                [np.array(c, float).reshape(-1, 2) for c in f["slam_cones"]],
                np.array(f["car_position"], float), np.array(f["car_direction"], float),
            )
            for f in frames
        ])

    def plan(config: dict, frames: list) -> np.ndarray:
        status, body = _request(url + "/plan", json.dumps({"config": config, "frames": frames}).encode())
        check(status == 200, f"/plan returned {status}: {body}")
        return np.asarray(body["paths"])

    server = serve.PlanServer(("127.0.0.1", 0), device=dev)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, page = _request(url + "/")
        check(status == 200 and b"/plan" in page, "GET / did not return the page")
        status, data = _request(url + "/scenarios")
        fixtures = data["scenarios"]
        check(status == 200 and len(fixtures) == 8 and set(data["knobs"]) == set(serve._KNOBS), "GET /scenarios")

        reset_counts()
        served = np.stack([plan({}, [f])[0] for f in fixtures.values()])
        launches = read_counts("plan server, fixture requests")
        want = direct({}, list(fixtures.values()))
        err = float(np.abs(served - want).max())
        log(f"plan server: {len(fixtures)} fixture requests, max |served - direct PathPlanner| {err!r} m; launches {launches}")
        check(np.isfinite(served).all() and err <= 1e-4, "served fixture paths differ from the direct facade's")

        session = json.loads(SESSION.read_bytes())[:20]
        big = {"n_cones": REPLAY_N_CONES}
        served = np.concatenate([plan(big, session[:10]), plan(big, session[10:])])
        err = float(np.abs(served - direct(big, session)).max())
        log(f"plan server: 20 session frames over two requests at n_cones {REPLAY_N_CONES}, max |served - direct 20-frame run| {err!r} m")
        check(err <= 1e-4, "the server did not carry the planner's state across requests")

        narrow = {"beam_width": 16}
        before = len(server.planners)
        reset_counts()
        served = plan(narrow, [fixtures["hairpin"]])
        narrow_launches = read_counts("plan server, beam width 16")
        knob_counts.update(bs.launch_count_by_instantiation)
        err = float(np.abs(served - direct(narrow, [fixtures["hairpin"]])).max())
        log(f"plan server: beam_width 16 on a new planner ({before} -> {len(server.planners)} planners), max |served - direct| {err!r} m, launches {narrow_launches}")
        check(len(server.planners) == before + 1 and err <= 1e-4, "beam_width 16 did not get its own planner, or differs")

        # B2's other instantiations through the server's knobs, and beam width
        # 10, which the kernel does not take: the sorter's scan, chosen by
        # shape before any launch, gives what a planner forced to the scan gives
        for knob in SERVE_KERNEL_KNOBS:
            reset_counts()
            served = plan(knob, [fixtures["hairpin"], fixtures["corner_missing_blue"]])
            knob_launches = read_counts(f"plan server, {knob}")
            knob_launches["B2 by instantiation"] = dict(bs.launch_count_by_instantiation)
            sorting_cfg = serve._build_config(knob).sorting
            want_inst = bs.instantiation(sorting_cfg.beam_width, sorting_cfg.max_length, sorting_cfg.max_n_neighbors)
            err = float(np.abs(served - direct(knob, [fixtures["hairpin"], fixtures["corner_missing_blue"]])).max())
            with env(FT_FSD_FUSED_BEAM="0"):
                scan_err = float(np.abs(served - direct(knob, [fixtures["hairpin"], fixtures["corner_missing_blue"]])).max())
            log(
                f"plan server: {knob} -> 200, max |served - direct PathPlanner| {err!r} m, against the sorter's "
                f"scan {scan_err!r} m; launches {knob_launches}"
            )
            check(np.isfinite(served).all() and err <= 1e-4, f"{knob}: served paths differ from the direct facade's")
            check(knob_launches["B2 by instantiation"].get(want_inst, 0) > 0, f"{knob} did not launch B2 {want_inst}")
            for inst, n in knob_launches["B2 by instantiation"].items():
                knob_counts[inst] = knob_counts.get(inst, 0) + n
        reset_counts()
        served = plan(SERVE_SCAN_KNOB, [fixtures["hairpin"], fixtures["corner_missing_blue"]])
        scan_launches = read_counts(f"plan server, {SERVE_SCAN_KNOB}", sorts=False)
        with env(FT_FSD_FUSED_BEAM="0"):
            err = float(np.abs(served - direct(SERVE_SCAN_KNOB, [fixtures["hairpin"], fixtures["corner_missing_blue"]])).max())
        log(f"plan server: {SERVE_SCAN_KNOB} -> 200 through the sorter's scan, launches {scan_launches}, max |served - FT_FSD_FUSED_BEAM=0 facade| {err!r} m")
        check(np.isfinite(served).all() and err <= 1e-4, f"{SERVE_SCAN_KNOB}: served paths differ from the scan's")

        status, body = _request(url + "/plan", b'{"frames": [{"car_position": [0.0, 0.0]}]}')
        check(status == 500 and "slam_cones" in body["error"], f"a malformed request returned {status}")
        check(np.isfinite(plan({}, [fixtures["straight"]])).all(), "the request after a malformed one failed")
        log("plan server: malformed request -> 500 with the error, the next request -> 200")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "the plan server's thread did not stop")
    launches["B2 by instantiation, knob requests"] = knob_counts
    return launches


def phase_export_viz(dev) -> dict:
    """The viewer export on the card: every fixture and 10 session frames
    (n_cones 256), paths of 40 finite points, viz_data.js under build/."""
    from ft_fsd_path_planning_torch.demo import export_viz
    from ft_fsd_path_planning_torch.demo.scenarios import ALL_SCENARIOS

    out = ROOT / "build" / "viz"
    reset_counts()
    export_viz.main(["--out", str(out), "--max-session-frames", "10", "--device", str(dev)])
    launches = read_counts("export_viz")
    js = (out / "viz_data.js").read_text()
    prefix = "window.VIZ_DATA = "
    check(js.startswith(prefix) and (out / "interactive.html").exists(), "viz_data.js or interactive.html missing")
    payload = json.loads(js[len(prefix):].rstrip().rstrip(";"))
    frames = [*payload["scenarios"].values(), *payload["session"]]
    check(set(payload["scenarios"]) == set(ALL_SCENARIOS) and len(payload["session"]) == 10, "viewer payload frames")
    for frame in frames:
        path = np.asarray(frame["path"], float)
        check(path.shape == (40, 2) and np.isfinite(path).all(), "a viewer path is not 40 finite points")
    log(f"export_viz: {len(payload['scenarios'])} fixtures and {len(payload['session'])} session frames, {len(js)} B of viz_data.js; launches {launches}")
    return launches


def compare_sharded(label: str, paths: torch.Tensor, metrics: dict, want, want_metrics, same_rows: bool) -> float:
    """Hold a sharded run's stitched paths and reduced metrics against
    ``batched_step``'s; returns the max lateral deviation. With
    ``same_rows`` (one rank: the same batch as ``batched_step``) every
    metric equals batch_metrics' to METRICS_REL_TOL; split over ranks, each
    rank's smaller batch reassociates float sums, a frame's 20 m trim can
    keep or drop its last 0.165 m sample, and the mean path length is held
    to 0.1 m and the mean curvature to 1% (tests/test_distributed.py's
    bar), the counts and rates exactly."""
    dev_m = float(lateral(paths.to(want.path.device), want.path).max())
    rel = {k: abs(metrics[k] - float(v)) / max(abs(float(v)), 1e-12) for k, v in want_metrics._asdict().items()}
    log(f"{label}: max lateral vs batched_step {dev_m!r} m; metrics {metrics}; relative difference from batch_metrics {rel}")
    check(paths.shape == want.path.shape and bool(torch.isfinite(paths).all()), f"{label}: bad paths")
    check(dev_m < SHARDED_LATERAL_TOL, f"{label}: paths differ from batched_step's")
    if same_rows:
        check(max(rel.values()) <= METRICS_REL_TOL, f"{label}: metrics differ from batch_metrics")
    else:
        exact = ("n_frames", "solve_success_rate", "too_far_rate", "relocalized_rate", "spline_budget_hit_rate")
        check(all(rel[k] <= METRICS_REL_TOL for k in exact), f"{label}: counts or rates differ from batch_metrics")
        check(abs(metrics["mean_path_length"] - float(want_metrics.mean_path_length)) <= 0.1, f"{label}: mean path length")
        check(rel["mean_abs_curvature"] <= 1e-2, f"{label}: mean curvature")
    return dev_m


def phase_distributed(cfg, dev) -> dict:
    """The sharded step at the default configuration, global B = 256, against
    ``batched_step``: a one-rank NCCL group in this process, then a two-rank
    gloo group of two processes on this card (NCCL refuses two ranks on one
    card), then ``dryrun_multichip(2)`` at ``large_map_config``. Returns the
    kernels' launches per rank."""
    import torch.distributed as dist

    from ft_fsd_path_planning_torch.parallel import batch, dryrun, scenarios, worker
    from ft_fsd_path_planning_torch.parallel.distributed import (
        global_mesh,
        host_local_slice,
        initialize_distributed,
        make_global_batch,
        make_global_state,
    )
    from ft_fsd_path_planning_torch.models.planner import FrameInput

    frames = scenarios.make_frame_batch(cfg, BATCH, seed=0, device=dev)
    want, _ = batch.batched_step(cfg, batch.make_batch_state(cfg, BATCH, dev), frames)
    want_metrics = batch.batch_metrics(want)

    initialize_distributed(f"tcp://localhost:{worker.free_port()}", 1, 0, backend="nccl", device=dev)
    try:
        mesh = global_mesh(device=dev)
        check(dist.get_backend(mesh.group) == "nccl" and mesh.size == 1, "not a one-rank NCCL group")
        lo, hi = host_local_slice(BATCH)
        local = FrameInput(*(a[lo:hi] for a in scenarios.make_frame_batch_numpy(cfg, BATCH, seed=0)))
        step = batch.sharded_batched_step(cfg, mesh)
        states, gframes = make_global_state(cfg, mesh, BATCH), make_global_batch(mesh, local, BATCH)
        reset_counts()
        outs, _, metrics = step(states, gframes)
        torch.cuda.synchronize()
        nccl_launches = read_counts("sharded_batched_step, one NCCL rank")
    finally:
        dist.destroy_process_group()
    nccl_dev = compare_sharded(
        f"sharded_batched_step, one NCCL rank, B={BATCH} (launches {nccl_launches})", outs.path,
        {k: float(v) for k, v in metrics._asdict().items()}, want, want_metrics, same_rows=True,
    )

    out = ROOT / "build" / "smoke_ranks"
    out.mkdir(parents=True, exist_ok=True)
    worker.spawn("step", 2, device=str(dev), backend="gloo", timeout=600, out=str(out), config="default",
                 global_batch=BATCH, seed=0)
    reports = [json.loads((out / f"rank_{r}.json").read_text())["configs"]["default"] for r in (0, 1)]
    paths = torch.cat([torch.as_tensor(np.load(out / f"paths_default_{r}.npy")) for r in (0, 1)])
    check([(r["lo"], r["hi"]) for r in reports] == [(0, BATCH // 2), (BATCH // 2, BATCH)], "the ranks' slices")
    check(reports[0]["metrics"] == reports[1]["metrics"], "the two ranks' metrics differ")
    gloo_launches = [r["launches"] for r in reports]
    for rank, launches in enumerate(gloo_launches):
        check(launches["B1"] > 0 and launches["B2"] == 1, f"gloo rank {rank} launched {launches}")
    gloo_dev = compare_sharded(
        f"sharded_batched_step, two gloo ranks on one card, global B={BATCH} (launches per rank {gloo_launches})",
        paths, reports[0]["metrics"], want, want_metrics, same_rows=False,
    )

    line = dryrun.dryrun_multichip(2, device=dev, timeout=600)
    log(f"dryrun_multichip(2) at large_map_config: {line}")
    return {"nccl_one_rank": nccl_launches, "gloo_two_ranks": gloo_launches,
            "lateral_max_m": {"nccl_one_rank": nccl_dev, "gloo_two_ranks": gloo_dev}}


def phase_profile(cfg, dev) -> None:
    """A short profile_device run (B = 32): every kernel and every sync of
    the step credited to a source line, the lines adding up to the step's
    totals, which agree with what the profiler and the sync debug mode count
    for the same step on their own (kernels within 0.1%, syncs within 2)."""
    from ft_fsd_path_planning_torch import profile_device
    from ft_fsd_path_planning_torch.parallel import batch, scenarios

    b = 32
    out = profile_device.profile_step("trackdrive", b, N_CONES, dev, top=5)
    frames = scenarios.make_frame_batch(cfg, b, seed=0, device=dev)
    state = batch.make_batch_state(cfg, b, dev)
    step = lambda: batch.batched_step(cfg, state, frames)  # noqa: E731
    kernels, syncs = kernel_count(step), count_syncs(step)
    lines = sum(v["kernels"] for v in out["all_lines"].values())
    sync_lines = sum(v["syncs"] for v in out["sync_lines"].values())
    log(
        f"profile_device B={b}: {out['total']} kernels over {out['lines']} lines (sum {lines}; not under a "
        f"range {out['unowned']}), {out['syncs']} syncs over {len(out['sync_lines'])} lines (sum {sync_lines}); "
        f"the same step counted apart: {kernels} kernels, {syncs} syncs; by stage {out['by_stage']}; "
        f"fitpack lines by syncs {out['fitpack_sync_lines']}"
    )
    check(lines == out["total"] and sync_lines == out["syncs"], "profile_device's lines do not add up to its totals")
    log("profile_device syncs by line: " + json.dumps({k: v["syncs"] for k, v in out["sync_lines"].items()}))
    # the profiled step may launch a kernel or make a sync more or fewer than
    # the same step on its own (the profiler's own work, the allocator): a
    # few, not a stage's worth
    check(abs(out["total"] - kernels) <= max(2, kernels // 1000) and abs(out["syncs"] - syncs) <= 2,
          "profile_device's totals differ from the step's")


def phase_stage_viz(dev) -> dict:
    """stage_viz's data half on the card for two scenarios: finite arrays of
    the expected shapes (no drawing: the card's machine need not have
    matplotlib)."""
    from ft_fsd_path_planning_torch.demo import stage_viz

    reset_counts()
    for name in ("hairpin", "simple_corner"):
        data = stage_viz.stage_data(name, device=dev)
        beams = data["beam"].values()
        check(data["path"].shape == (40, 4) and np.isfinite(data["path"]).all(), f"stage_data {name}: path")
        check(all(b["configs"].ndim == 2 and b["valid"].any() and np.isfinite(b["costs"][b["valid"]]).all() for b in beams),
              f"stage_data {name}: beam pool")
        check(all(len(e) > 0 and e.shape[1] == 2 for e in data["adjacency"].values()), f"stage_data {name}: adjacency")
        log(
            f"stage_data {name} on the card: path (40, 4) finite, adjacency edges "
            f"{[len(e) for e in data['adjacency'].values()]}, valid pool {[int(b['valid'].sum()) for b in beams]}, "
            f"matches {len(data['matches']['left_to_right'])}/{len(data['matches']['right_to_left'])}"
        )
    return read_counts("stage_data")


def main() -> int:
    kernels_only = sys.argv[1:] == ["--kernels-only"]
    if sys.argv[1:] and not kernels_only:
        print("usage: python3 chip_smoke.py [--kernels-only]", file=sys.stderr)
        return 1
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
    b1_bare, b1_fused = phase_b1_vs_plain(cfg, dev)
    timed(phase_b1_vs_plain_missions, dev)
    b2 = phase_b2_vs_plain(cfg, replay_cfg, dev)
    b2_shapes = timed(phase_b2_shapes, cfg, dev)
    if kernels_only:
        log("kernels-only run: the main path was not driven, no result line")
        return 2
    timed(phase_loader)
    step_launches = timed(phase_batched_step, cfg, dev)
    replay_launches, facade_paths = timed(phase_replay, replay_cfg, dev)
    bench_launches = timed(phase_bench, dev, facade_paths)
    mission_launches = timed(phase_mission_replay, dev)
    mission_batch_launches = timed(phase_mission_batched_step, dev)
    global_path_launches = timed(phase_global_path, dev)
    cli_launches = timed(phase_demo)
    serve_launches = timed(phase_serve, dev)
    viz_launches = timed(phase_export_viz, dev)
    distributed_launches = timed(phase_distributed, cfg, dev)
    timed(phase_profile, cfg, dev)
    stage_viz_launches = timed(phase_stage_viz, dev)
    log(f"all phases, the kernels' build included: {time.perf_counter() - START!r} s of the {TIME_LIMIT_S} s a run may take")
    # B1's two entries are one kernel: the first row counts its launches
    # through either entry and times the bare one, the second is the fused
    # entry, the one the main path takes
    rows = ((b1_bare, "B1"), (b1_fused, "B1 fused entry"), (b2, "B2"))
    for kernel, count in rows:
        kernel["launches"] = step_launches[count]  # one batched_step at B = 256
        kernel["launches_replay"] = replay_launches["replay"][count]
        kernel["launches_cached_replay"] = replay_launches["cached_replay"][count]
        # the relocalizer missions: per session replay (B = 1; all frames, and the median a frame for B1),
        # per batched step at B = 256 from a fresh and from the relocalized state; trackdrive with a global path
        kernel["launches_mission_replay"] = {k: v[count] for k, v in mission_launches.items()}
        kernel["launches_mission_batched_step"] = {
            f"{k}, {start}": v[start][count] for k, v in mission_batch_launches.items() for start in v
        }
        kernel["launches_global_path"] = {k: v[count] for k, v in global_path_launches.items()}
        # the front doors: bench_torch.py (per batched_step and the whole run), the replay CLI
        # (40 frames in colour, 20 without), the plan server's eight fixture requests, the viewer export
        per_step = count.split()[0]  # the main path takes B1's fused entry alone (checked in phase_bench)
        kernel["launches_bench"] = {
            "run": bench_launches["run"][count],
            "per batched_step": {k: v[per_step] for k, v in bench_launches["batch_step"].items()},
        }
        kernel["launches_cli"] = {k: v[per_step] for k, v in cli_launches.items()}
        kernel["launches_serve_fixtures"] = serve_launches[count]
        kernel["launches_export_viz"] = viz_launches[count]
        # the sharded step at B = 256: one NCCL rank, each of two gloo ranks; the stage viewer's data
        kernel["launches_sharded_step"] = {
            "nccl one rank": distributed_launches["nccl_one_rank"][per_step],
            "gloo two ranks": [r[per_step] for r in distributed_launches["gloo_two_ranks"]],
        }
        kernel["launches_stage_viz"] = stage_viz_launches[count]
    # B2's other instantiations: launched by the plan server's knob requests
    knob_counts = serve_launches["B2 by instantiation, knob requests"]
    for row in b2_shapes:
        row["launches"] = knob_counts.get(row["name"].split(" ", 1)[1], 0)
        row["launches_path"] = "the plan server's knob requests (beam width 8, 16, 64; max length 8, 16)"
        check(row["launches"] > 0, f"{row['name']} was launched no time by the plan server's knob requests")
    b1_bare["launches_mission_frame"] = {k: v["b1_per_frame"] for k, v in mission_launches.items()}
    b1_bare["launches_bare_entry"] = step_launches["B1 bare entry"]
    log(json.dumps({"kernels": [kernel for kernel, _ in rows] + b2_shapes}))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
