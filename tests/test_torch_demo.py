"""The port's demos against the JAX package's, on the CPU.

* `demo/scenarios.py`: every fixture of `ALL_SCENARIOS` gives the JAX
  package's arrays bit for bit.
* Each fixture through the port's `PathPlanner` (fresh planner, n_cones =
  128) lies within 1 cm laterally of the JAX facade's path, with the same
  number of sorted cones on each side.
* `demo/json_demo.py`: `load_data_json` (with and without
  `--remove-color-info`) and `select_mission_by_filename` equal the JAX
  package's; `main([... "--device", "cpu"])` replays frames and prints the
  frames line and the kernel launches (none on the CPU).
* `demo/export_viz.py`: `build_payload(max_session_frames=2)` has the JAX
  payload's keys, and its paths lie within 1 cm of the JAX payload's.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ft_fsd_path_planning_tpu import MissionTypes as JMissionTypes
from ft_fsd_path_planning_tpu import PathPlanner as JPathPlanner
from ft_fsd_path_planning_tpu.demo import export_viz as jexport
from ft_fsd_path_planning_tpu.demo import json_demo as jdemo
from ft_fsd_path_planning_tpu.demo import scenarios as jscenarios
from ft_fsd_path_planning_torch import MissionTypes, PathPlanner
from ft_fsd_path_planning_torch.demo import export_viz, json_demo, scenarios
from tests.torch_parity import path_parity_deviation

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SESSION = REPO / "ft_fsd_path_planning_tpu/demo/closed_track_session.json"
LATERAL_TOL = 0.01
NAMES = sorted(jscenarios.ALL_SCENARIOS)


@pytest.mark.parametrize("name", NAMES)
def test_fixture_arrays_equal_jax(name):
    assert sorted(scenarios.ALL_SCENARIOS) == NAMES
    ours, theirs = scenarios.ALL_SCENARIOS[name](), jscenarios.ALL_SCENARIOS[name]()
    cones, pos, direction = ours
    jcones, jpos, jdirection = theirs
    assert len(cones) == len(jcones) == 5
    for a, b in zip([*cones, pos, direction], [*jcones, jpos, jdirection]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_noisy_corner_keeps_its_seeded_stream():
    for seed in (0, 1, 7):
        a, b = scenarios.noisy_corner(seed, 0.2)[0], jscenarios.noisy_corner(seed, 0.2)[0]
        assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))
    assert scenarios.noisy_corner(1)[0][2].tobytes() != scenarios.noisy_corner(2)[0][2].tobytes()


@pytest.mark.parametrize("name", NAMES)
def test_fixture_paths_match_jax(name):
    cones, pos, direction = scenarios.ALL_SCENARIOS[name]()
    ours = PathPlanner(MissionTypes.trackdrive, device="cpu").calculate_path_in_global_frame(
        cones, pos, direction, return_intermediate_results=True
    )
    theirs = JPathPlanner(JMissionTypes.trackdrive).calculate_path_in_global_frame(
        cones, pos, direction, return_intermediate_results=True
    )
    assert ours[0].shape == (40, 4) and np.isfinite(ours[0]).all()
    dev = path_parity_deviation(np.asarray(theirs[0]), ours[0])
    assert dev < LATERAL_TOL, (name, dev)
    assert [len(x) for x in ours[1:3]] == [len(x) for x in theirs[1:3]]


@pytest.mark.parametrize("remove_color_info", [False, True])
def test_load_data_json_equals_jax(remove_color_info):
    ours = json_demo.load_data_json(SESSION, remove_color_info)
    theirs = jdemo.load_data_json(SESSION, remove_color_info)
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[1], theirs[1])
    assert len(ours[2]) == len(theirs[2]) == 300
    for frame, jframe in zip(ours[2], theirs[2]):
        assert len(frame) == len(jframe) == 5
        for a, b in zip(frame, jframe):
            assert a.shape == b.shape and a.tobytes() == b.tobytes()
    if remove_color_info:
        assert all(len(f[0]) == 138 and sum(len(c) for c in f[1:]) == 0 for f in ours[2])


@pytest.mark.parametrize("name", ["skidpad.json", "FSG_accel_run.json", "Acceleration.JSON", "trackdrive.json", "autocross_fss.json"])
def test_select_mission_by_filename_equals_jax(name):
    assert json_demo.select_mission_by_filename(name).name == jdemo.select_mission_by_filename(name).name


def test_cli_main_replays_frames_on_the_cpu(capsys):
    json_demo.main([str(SESSION), "--device", "cpu", "--max-frames", "3"])
    out = capsys.readouterr().out
    assert "mission: trackdrive" in out
    match = re.search(r"frames: (\d+)  mean: ([\d.]+) ms  p50: ([\d.]+) ms  p99: ([\d.]+) ms", out)
    assert match and int(match.group(1)) == 3, out
    assert all(np.isfinite(float(match.group(i))) for i in (2, 3, 4))
    assert 'kernel launches: {"B1": 0, "B2": 0}' in out


def _as_path(points):
    """(H, 2) payload points as an (H, 4) path whose first column is the
    chord length along it, for a comparison over the common span."""
    xy = np.asarray(points, float).reshape(-1, 2)
    s = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(xy, axis=0), axis=1))])
    return np.concatenate([s[:, None], xy, np.zeros((len(xy), 1))], axis=1)


def test_build_payload_matches_jax():
    ours = export_viz.build_payload(max_session_frames=2, device="cpu")
    theirs = jexport.build_payload(max_session_frames=2)
    assert ours.keys() == theirs.keys()
    assert ours["scenarios"].keys() == theirs["scenarios"].keys() == set(NAMES)
    assert len(ours["session"]) == len(theirs["session"]) == 2
    frames = [*ours["scenarios"].values(), *ours["session"]]
    jframes = [*theirs["scenarios"].values(), *theirs["session"]]
    for frame, jframe in zip(frames, jframes):
        assert frame.keys() == jframe.keys()
        assert frame["cones"] == jframe["cones"] and frame["pos"] == jframe["pos"]
        path, jpath = _as_path(frame["path"]), _as_path(jframe["path"])
        assert path.shape == (40, 4) and np.isfinite(path).all()
        dev = path_parity_deviation(jpath, path)
        assert dev < LATERAL_TOL, dev
