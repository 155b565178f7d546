"""The port's session loader and session generator against the JAX package.

* The C++ and the Python engine of `ft_fsd_path_planning_torch.native.loader`
  give the same arrays bit for bit, and the same as the JAX package's
  Python loader, on the committed session at n_max 256 and 128 and on a
  small hand-written session with empty lists, orange cones, a frame over
  its budget and a truncated frame count.
* A failed build raises and does not fall back; so does a failed parse; the
  Python engine runs only when asked for by name.
* `demo/make_session.py`: `generate_session()` gives the committed file and
  the JAX package's frames, `ground_truth()` the JAX package's arrays, bit
  for bit; `main()` writes only to its `--out` path.
* `replay_frames` gives a (T, 1, ...) FrameInput on the requested device.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ft_fsd_path_planning_tpu.demo import make_session as jmake
from ft_fsd_path_planning_tpu.native import loader as jloader
from ft_fsd_path_planning_torch.demo import make_session
from ft_fsd_path_planning_torch.native import loader

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SESSION = REPO / "ft_fsd_path_planning_tpu/demo/closed_track_session.json"

SMALL_SESSION = [
    {
        "car_position": [1.25, -0.5],
        "car_direction": [0.6, 0.8],
        "slam_cones": [[], [[3.0, -1.5], [6.1, -1.4]], [[3.0, 1.5]], [[0.1, 0.2]], [[9.5, 1.0], [9.5, -1.0]]],
    },
    {
        "car_position": [2.0, 0.0],
        "car_direction": [1.0, 0.0],
        "slam_cones": [[], [], [], [], []],
    },
    {
        "car_position": [3.0, 0.1],
        "car_direction": [1.0, 0.0],
        "slam_cones": [[[0.5, 0.5], [1.5, 1.5], [2.5, 2.5]], [[4.0, -1.5]], [[4.0, 1.5], [7.0, 1.5]], [], [[1e-3, -2.5e2]]],
    },
]


def _bits(arrays):
    return [(a.dtype, a.shape, a.tobytes()) for a in arrays]


@pytest.fixture
def small_session(tmp_path):
    path = tmp_path / "small_session.json"
    path.write_text(json.dumps(SMALL_SESSION))
    return path


@pytest.mark.parametrize("n_max", [256, 128])
def test_engines_equal_on_the_committed_session(n_max):
    cpp = loader.load_session(SESSION, n_max=n_max)
    python = loader.load_session(SESSION, n_max=n_max, engine="python")
    jax_python = jloader._load_python(str(SESSION), n_max, 4096)
    assert cpp[0].shape == (300, n_max, 3)
    assert [a.dtype for a in cpp] == [np.float32, np.uint8, np.float32, np.float32]
    assert _bits(cpp) == _bits(python) == _bits(jax_python)
    assert int(cpp[1].sum(axis=1).min()) == min(138, n_max)  # the whole map of 138 cones, cut to the budget


@pytest.mark.parametrize("n_max, max_frames", [(16, 4096), (4, 4096), (8, 2)])
def test_engines_equal_on_a_small_session(small_session, n_max, max_frames):
    cpp = loader.load_session(small_session, n_max=n_max, max_frames=max_frames)
    python = loader.load_session(small_session, n_max=n_max, max_frames=max_frames, engine="python")
    jax_python = jloader._load_python(str(small_session), n_max, max_frames)
    assert _bits(cpp) == _bits(python) == _bits(jax_python)
    cones, mask, positions, directions = cpp
    assert len(cones) == min(len(SMALL_SESSION), max_frames)
    # frame 0: types in list order, orange cones coded 3 and 4, padding -1
    want = [1, 1, 2, 3, 4, 4] + [-1] * (n_max - 6)
    np.testing.assert_array_equal(cones[0, :, 2], np.array(want[:n_max], np.float32))
    assert mask[1].sum() == 0 and (cones[1, :, 2] == -1).all()
    np.testing.assert_array_equal(positions[0], np.float32([1.25, -0.5]))
    np.testing.assert_array_equal(directions[0], np.float32([0.6, 0.8]))


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(loader, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(loader, "_lib", None)
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        loader.load_session(SESSION, n_max=128)
    assert not loader.library_path().exists()


def test_failed_compile_raises(tmp_path, monkeypatch):
    bad = tmp_path / "replay_loader.cpp"
    bad.write_text("int rl_load_session( {\n")
    monkeypatch.setattr(loader, "SRC", bad)
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(loader, "_lib", None)
    with pytest.raises(RuntimeError, match="failed to build"):
        loader.load_session(SESSION, n_max=128)


def test_failed_parse_raises(tmp_path):
    broken = tmp_path / "broken.json"
    broken.write_text('[{"car_position": [1.0, 2.0], "slam_cones": [[[1.0, ')
    with pytest.raises(RuntimeError, match="could not read or parse"):
        loader.load_session(broken)
    with pytest.raises(RuntimeError, match="could not read or parse"):
        loader.load_session(tmp_path / "missing.json")
    with pytest.raises(ValueError, match="engine"):
        loader.load_session(SESSION, engine="numpy")


def test_library_is_built_once_in_the_build_directory():
    path = loader.build()
    assert path.parent == REPO / "build" / "native"
    assert path.exists() and loader.build() == path
    assert loader.library_path().name.startswith("libreplay_loader-")


def test_generate_session_equals_the_committed_file_and_jax():
    ours = make_session.generate_session()
    assert json.dumps(ours) == json.dumps(jmake.generate_session())
    assert json.loads(SESSION.read_text()) == json.loads(json.dumps(ours))
    assert make_session.SESSION_PATH == SESSION
    assert (make_session.SEED, make_session.N_LAPS, make_session.FRAMES_PER_LAP, make_session.OBS_NOISE) == (
        jmake.SEED, jmake.N_LAPS, jmake.FRAMES_PER_LAP, jmake.OBS_NOISE
    )


def test_ground_truth_equals_jax():
    ours, theirs = make_session.ground_truth(), jmake.ground_truth()
    assert len(ours) == len(theirs) == 5
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_make_session_main_writes_only_its_out_path(tmp_path):
    before = SESSION.stat().st_mtime_ns
    out = tmp_path / "session.json"
    make_session.main(["--out", str(out)])
    assert out.read_text() == SESSION.read_text()
    assert SESSION.stat().st_mtime_ns == before


def test_replay_frames_on_the_cpu():
    arrays = loader.load_session(SESSION, n_max=256, max_frames=3)
    frames = loader.replay_frames(*arrays, device="cpu")
    assert frames.cones.shape == (3, 1, 256, 3) and frames.cones.dtype == torch.float32
    assert frames.mask.shape == (3, 1, 256) and frames.mask.dtype == torch.bool
    assert frames.position.shape == (3, 1, 2) and frames.direction.shape == (3, 1, 2)
    np.testing.assert_array_equal(frames.cones[:, 0].numpy(), arrays[0])
    np.testing.assert_array_equal(frames.mask[:, 0].numpy(), arrays[1].astype(bool))


def test_make_session_cli_runs(tmp_path):
    out = tmp_path / "cli_session.json"
    subprocess.run(
        [sys.executable, "-m", "ft_fsd_path_planning_torch.demo.make_session", "--out", str(out)],
        cwd=REPO, check=True, timeout=120, capture_output=True,
    )
    assert len(json.loads(out.read_text())) == 300
