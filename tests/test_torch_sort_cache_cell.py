"""The benchmark cell `trackdrive.online-cached` on the CPU: the port's
facade with the sorting-result cache over 40 frames of the cell's traffic
(seed 0), driven as the cell's online loop drives them.

* Every answer lies within the configuration's `path_gap_m` of the
  benchmark's plain reference (`benchmark/reference/planner.py`): a hit
  reuses the order a fresh sort would give.
* The port's hit sequence is the plain reference of the hit rule's
  (`benchmark/reference/sort_cache.py`); a frame where they differ must
  have a cone within 1 mm of the 0.1 m threshold.
* Both hits and misses occur, 10 or more of each.
* The cache's counters and span: one lookup and one `stage.facade.sort_cache`
  span a frame, one hit a hit; a planner without the cache counts nothing.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ft_fsd_path_planning_torch import PathPlanner
from ft_fsd_path_planning_torch.utils import timer

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
CELL = "trackdrive.online-cached"
SEED, N_FRAMES = 0, 40
KNIFE_EDGE_M = 1e-3


@pytest.fixture(scope="module")
def bench():
    """The benchmark's cell lookup, program configuration, comparison and
    the reference of the hit rule, imported as its runner imports them (the
    harness's directory on the path)."""
    if str(BENCH) not in sys.path:
        sys.path.append(str(BENCH))
    from harness import cell as cells
    from harness.program import planner_config
    from reference import sort_cache
    from reference.compare import lateral_gap

    return cells, planner_config, sort_cache, lateral_gap


@pytest.fixture(scope="module")
def drive(bench):
    """40 frames of the cell from the station its loop starts at: (cell,
    track module, drive, frame indices, per frame (path, whether it hit),
    the recorded table)."""
    cells, planner_config, _, _ = bench
    cell = cells.load_cell(CELL)
    track = cells.track_module(cell)
    drive = track.Drive(cell.config, cell.traffic, SEED)
    start = drive.start(np.random.default_rng([SEED, 0]))
    cfg = planner_config(cell.config)
    planner = PathPlanner(cfg.mission, config=cfg, device="cpu")
    keys = list(range(start, start + N_FRAMES))
    answers = []
    timer.reset()
    try:
        with timer.recording():
            for i in keys:
                frame = drive.frame(i)[0]
                before = planner.sort_cache_hits
                path = planner.calculate_path_in_global_frame(frame.cones, frame.position, frame.direction)
                answers.append((path, planner.sort_cache_hits > before))
        table = timer.table()
    finally:
        timer.reset()
    return cell, track, drive, keys, answers, table, planner.sort_cache_hits


def test_the_cell_runs_the_cache(drive):
    cell = drive[0]
    assert cell.config["planner"]["experimental_performance_improvements"] is True
    assert cell.traffic["closed_track"]["frames_per_lap"] == 480


def test_every_answer_lies_within_the_limit_of_the_reference(bench, drive):
    lateral_gap = bench[3]
    cell, track, d, keys, answers, _, _ = drive
    limit = cell.config["check"]["path_gap_m"]
    gaps = {}
    for i, (path, _) in zip(keys, answers):
        ref = track.reference(d, i)
        assert ref is not None and path.shape == (40, 4) and np.all(np.isfinite(path))
        gaps[i] = lateral_gap(path, ref)
    assert max(gaps.values()) <= limit, gaps


def test_hits_are_the_reference_rules(bench, drive):
    sort_cache = bench[2]
    _, _, d, keys, answers, _, _ = drive
    frames = [d.frame(i)[0] for i in keys]
    theirs = sort_cache.hit_sequence(frames)
    ours = [hit for _, hit in answers]
    differ = {}
    for k, (a, b) in enumerate(zip(ours, theirs)):
        if a != b:
            dist = sort_cache.distances(frames[k - 1], frames[k])
            differ[keys[k]] = dist
            edge = min(abs(v - sort_cache.THRESHOLD_M) for v in dist.values())
            assert edge <= KNIFE_EDGE_M, (keys[k], a, b, dist)
    print(f"frames whose hit differs from the reference's, with each test's largest distance: {differ}")
    assert sum(ours) >= 10 and N_FRAMES - sum(ours) >= 10, ours


def test_counters_and_span_count_every_lookup_and_hit(drive):
    _, _, _, _, answers, table, hits = drive
    assert table["facade.sort_cache.lookups"] == N_FRAMES
    assert table["facade.sort_cache.hits"] == hits == sum(hit for _, hit in answers)
    assert table["stage.facade.sort_cache"]["n"] == N_FRAMES
    assert table["stage.facade.step"]["n"] == N_FRAMES


def test_a_planner_without_the_cache_counts_nothing(bench, drive):
    cells, planner_config, _, _ = bench
    cell = cells.load_cell("trackdrive.laps")
    assert cell.config["planner"]["experimental_performance_improvements"] is False
    cfg = planner_config(cell.config)
    planner = PathPlanner(cfg.mission, config=cfg, device="cpu")
    d = drive[2]
    timer.reset()
    try:
        with timer.recording():
            for i in drive[3][:2]:
                frame = d.frame(i)[0]
                planner.calculate_path_in_global_frame(frame.cones, frame.position, frame.direction)
        table = timer.table()
    finally:
        timer.reset()
    assert table["stage.facade.call"]["n"] == 2
    assert not {k for k in table if "sort_cache" in k}, table
