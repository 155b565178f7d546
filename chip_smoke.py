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
sorting cache and through ``replay_scan``. ``--kernels-only`` stops after
the kernels' own phases. It checks the paths against the reference planner's golden
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
B2_FLOAT_TOL = 1e-6  # B2 vs plain version, float feature rows, absolute (integer-coded rows: equal)
SESSION_CAPTURE_FRAMES = (0, 75, 150, 225)  # session frames whose searches B2 is checked on
B1_EXACT_TOL = 0.0  # B1's entries keep every entry's summation order: equal bit for bit
FUSED_F64_REL_TOL = 1e-5  # fused entry vs float64 solve on well-conditioned synthetic systems
LATERAL_TOL = 0.01  # kernel path vs plain-solve path, metres
FUSED_LATERAL_TOL = 0.0  # fused entry vs the composition of bare solves it replaces, metres
AB_ROUNDS = 15  # steps of each kind when two versions of batched_step are timed in turns
SIMILAR_THRESHOLD = 0.1  # the sort cache's cone-distance threshold, metres
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


def read_counts(path: str) -> dict:
    """Launches of both kernels since reset_counts(); every kernel must have
    been launched by the path just driven."""
    from ft_fsd_path_planning_torch.ops import banded_cholesky as bc
    from ft_fsd_path_planning_torch.ops import beam_search as bs

    counts = {"B1": bc.launch_count, "B2": bs.launch_count}
    for name, n in counts.items():
        check(n > 0, f"{path} did not launch {name}")
    check(bc.launch_count == bc.bare_launch_count + bc.refined_launch_count, "B1's counts do not add up")
    counts["B1 fused entry"] = bc.refined_launch_count
    counts["B1 bare entry"] = bc.bare_launch_count
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


def capture_main_path_solves(cfg, dev) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Run one batched step and keep the (dense matrix, rhs) of every refined
    solve the spline engine asks for, in call order."""
    from ft_fsd_path_planning_torch.ops import spline
    from ft_fsd_path_planning_torch.parallel import batch, scenarios

    seen: list[tuple[torch.Tensor, torch.Tensor]] = []
    original = spline.banded_refined_solve_cuda

    def recording(a, rhs):
        seen.append((a.clone(), rhs.clone()))
        return original(a, rhs)

    spline.banded_refined_solve_cuda = recording
    try:
        batch.batched_step(cfg, batch.make_batch_state(cfg, BATCH, dev), scenarios.make_frame_batch(cfg, BATCH, seed=1, device=dev))
        torch.cuda.synchronize()
    finally:
        spline.banded_refined_solve_cuda = original
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
    _, args1, kwargs1 = cases[1]
    eager_ms1 = cuda_ms(lambda: bs.fused_beam_search_cuda(*args1, **kwargs1), 100)
    ms1 = graph_ms(lambda: bs.fused_beam_search_cuda(*args1, **kwargs1), 100)
    log(
        f"B2 timing at G={args1[0].shape[0]} N={args1[0].shape[1]} (one frame of the replay): kernel {ms1!r} ms "
        f"from a CUDA graph ({eager_ms1!r} ms launched one by one)"
    )
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
        "timed": "CUDA graph replay of 100 launches; plain_ms and scan_ms launched one by one",
        "one_by_one_ms": eager_ms,
        "one_by_one_one_frame_ms": eager_ms1,
    }


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
    with similarity_log() as similarity:
        _, cached_launches = replay_facade(cached, args, golden["paths_cached"], "PathPlanner replay with the sort cache")
    report_similarity(similarity, len(args))
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
    b2 = phase_b2_vs_plain(cfg, replay_cfg, dev)
    if kernels_only:
        log("kernels-only run: the main path was not driven, no result line")
        return 2
    step_launches = phase_batched_step(cfg, dev)
    replay_launches = phase_replay(replay_cfg, dev)
    # B1's two entries are one kernel: the first row counts its launches
    # through either entry and times the bare one, the second is the fused
    # entry, the one the main path takes
    rows = ((b1_bare, "B1"), (b1_fused, "B1 fused entry"), (b2, "B2"))
    for kernel, count in rows:
        kernel["launches"] = step_launches[count]  # one batched_step at B = 256
        kernel["launches_replay"] = replay_launches["replay"][count]
        kernel["launches_cached_replay"] = replay_launches["cached_replay"][count]
    b1_bare["launches_bare_entry"] = step_launches["B1 bare entry"]
    log(json.dumps({"kernels": [kernel for kernel, _ in rows]}))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
