"""FITPACK's p-iteration on the trackdrive fit that once stopped far from
its smoothing target, held to SciPy and to the benchmark's plain reference.

The centerline fit of frame 22 of the trackdrive-fsg lap at seed 3100000006
(`tests/part2_check.py::WITNESS_POINTS`) takes branch 2 (p too small) after
p3 is set, and 25 p lies beyond p3. FITPACK (fpcurf.f) pulls that step back
inside the bracket; a step left outside it stopped the loop on the
monotonicity test at fp = 0.1288 against s = 0.2, and the path lay 19.8 mm
from the reference's. Here the fit converges as SciPy's `splprep` does, the
lanes whose float32 trial breaks down take the same step and converge, and
the port's paths over frames 15-25 of that lap lie within the benchmark
configuration's limit of the reference's (`benchmark/reference/`).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.interpolate import splev

from ft_fsd_path_planning_torch import PathPlanner
from ft_fsd_path_planning_torch.config import default_config
from ft_fsd_path_planning_torch.ops import fitpack
from ft_fsd_path_planning_torch.parallel import scenarios
from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes
from tests import part2_check

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
SEED, FRAMES = 3100000006, range(15, 26)


def test_witness_fit_meets_its_smoothing_target():
    points, mask = part2_check.witness_fit_inputs()
    s = part2_check.WITNESS_S
    fit = fitpack.fitpack_fit(points, mask, s)
    _, _, fp_scipy, ier = part2_check.witness_scipy()
    assert ier <= 0  # SciPy's FITPACK converges here
    assert bool(fit.ok[0]) and not bool(fit.budget_hit[0])
    assert abs(float(part2_check.fit_fp(fit, points, mask)[0]) - s) <= fitpack.TOL * s
    assert abs(fp_scipy - s) <= fitpack.TOL * s


def test_witness_fit_lies_within_a_millimetre_of_scipys():
    points, mask = part2_check.witness_fit_inputs()
    fit = fitpack.fitpack_fit(points, mask, part2_check.WITNESS_S)
    tck, u, _, _ = part2_check.witness_scipy()
    np.testing.assert_allclose(fit.t_int[0, : int(fit.n_int[0])].numpy(), tck[0][4:-4], atol=1e-4)
    grid = np.linspace(0.0, u[-1], 400)
    ours = fitpack.fitpack_eval(fit, torch.tensor(grid, dtype=torch.float32)[None])[0].numpy()
    theirs = np.stack(splev(grid, tck), axis=1)
    assert np.linalg.norm(ours - theirs, axis=1).max() < 1e-3


def test_witness_p_iteration_converges_in_the_plain_version():
    args = part2_check.witness()
    coef, trips = fitpack.fitpack_part2_plain(*args)
    s, acc = args[9], args[10]
    assert abs(float(part2_check.lane_fp(args, coef)[0]) - s) < acc
    assert 0 < int(trips[0]) < fitpack.MAXIT


def test_lanes_whose_trial_breaks_down_keep_their_bracket_and_converge():
    """Acceleration frame 0's fit of 704 sites with its middle knot closing
    in on its neighbour: the lanes whose float32 trial breaks down take
    branch 2's step and every one of them converges."""
    frames = scenarios.mission_sessions()["acceleration"][1]
    cfg = default_config(MissionTypes.acceleration, n_cones=128)
    planner = PathPlanner(MissionTypes.acceleration, config=cfg, device="cpu")
    calls = part2_check.capture(lambda: planner.calculate_path_in_global_frame(*frames[0]))
    broken = part2_check.broken_trials(next(a for a in calls if a[2].shape[1] == 704))
    coef, trips, retried = part2_check.plain_with_retries(broken)
    f = part2_check.lane_fp(broken, coef) - broken[9]
    assert broken[2].shape[0] > 0 and bool(retried.all())
    assert bool((f.abs() < broken[10]).all()), f
    assert bool((trips < fitpack.MAXIT).all())


@pytest.fixture(scope="module")
def bench():
    """The benchmark's cell lookup, track and reference, imported as its
    runner imports them (the harness's directory on the path)."""
    if str(BENCH) not in sys.path:
        sys.path.append(str(BENCH))
    from harness import cell as cells
    from harness.program import planner_config

    return cells, planner_config


def test_trackdrive_frames_lie_within_the_limit_of_the_reference(bench):
    cells, planner_config = bench
    from reference.compare import lateral_gap

    cell = cells.load_cell("trackdrive.laps")
    limit = json.loads((BENCH.parent / "benchmark/configs/trackdrive-fsg.json").read_text())["check"]["path_gap_m"]
    assert limit == cell.config["check"]["path_gap_m"]
    track = cells.track_module(cell)
    drive = track.Drive(cell.config, cell.traffic, SEED)
    cfg = planner_config(cell.config)
    planner = PathPlanner(cfg.mission, config=cfg, device="cpu")
    gaps = {}
    for i in FRAMES:
        frame = drive.frame(i)[0]
        path = planner.calculate_path_in_global_frame(frame.cones, frame.position, frame.direction)
        ref = track.reference(drive, i)
        assert ref is not None and path.shape == (40, 4)
        gaps[i] = lateral_gap(path, ref)
    assert max(gaps.values()) <= limit, gaps
