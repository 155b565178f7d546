"""The port's whole trackdrive slice against the JAX package and the
reference planner's golden paths.

* `batched_step` at B = 8 against JAX `batched_step` on the same
  `make_frame_batch` frames: paths agree laterally to 1 cm over their common
  span (float reassociation and the two packages' different but equally
  accurate spline solvers, see test_torch_fitpack.py); `path_ok` and the
  other per-frame flags are equal.
* `PathPlanner` over the first 40 frames of the committed 2-lap session at
  n_cones = 256 against `paths_plain` in `demo/trackdrive_golden.npz`: max
  under 5 cm and median under 1 cm, the bar tests/test_trackdrive_replay.py
  holds the JAX package to.
* `replay_scan` started through `interop.state_from_numpy` from a JAX
  planner state captured after 20 session frames: the next 5 paths agree
  with the JAX planner's to 1 cm laterally.
* `import ft_fsd_path_planning_torch` (every module of it) loads neither jax
  nor the JAX package, and the entry points refuse to run without a GPU
  unless the caller asks for the CPU.
"""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from ft_fsd_path_planning_tpu import MissionTypes as JMissionTypes
from ft_fsd_path_planning_tpu import PathPlanner as JPathPlanner
from ft_fsd_path_planning_tpu.config import default_config as jax_config
from ft_fsd_path_planning_tpu.models import facade as jfacade
from ft_fsd_path_planning_tpu.models.planner import FrameInput as JFrameInput
from ft_fsd_path_planning_tpu.parallel import batch as jbatch
from ft_fsd_path_planning_tpu.parallel import scenarios as jscen
import ft_fsd_path_planning_torch
from ft_fsd_path_planning_torch import MissionTypes, PathPlanner, interop
from ft_fsd_path_planning_torch.config import default_config as torch_config
from ft_fsd_path_planning_torch.models.planner import FrameInput
from ft_fsd_path_planning_torch.parallel import batch as tbatch
from ft_fsd_path_planning_torch.parallel import scenarios as tscen
from tests.torch_parity import path_parity_deviation

# the port's ops are small tensors: one intra-op thread is as fast here and
# leaves the cores to the other test workers
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SESSION = REPO / "ft_fsd_path_planning_tpu/demo/closed_track_session.json"
GOLDEN = REPO / "ft_fsd_path_planning_tpu/demo/trackdrive_golden.npz"
B, N = 8, 64
LATERAL_TOL = 0.01


def _frame_args(frame):
    cones = [np.array(c, np.float64).reshape(-1, 2) for c in frame["slam_cones"]]
    return cones, np.array(frame["car_position"], np.float64), np.array(frame["car_direction"], np.float64)


@pytest.fixture(scope="module")
def session():
    return json.loads(SESSION.read_bytes())


@pytest.fixture(scope="module")
def step_outputs():
    jcfg, tcfg = jax_config(n_cones=N), torch_config(n_cones=N)
    frames = jscen.make_frame_batch(jcfg, B, seed=0)
    step = jax.jit(lambda s, f: jbatch.batched_step(jcfg, s, f))
    theirs, _ = step(jbatch.make_batch_state(jcfg, B), frames)
    ours, _ = tbatch.batched_step(
        tcfg,
        tbatch.make_batch_state(tcfg, B, device="cpu"),
        tscen.make_frame_batch(tcfg, B, seed=0, device="cpu"),
    )
    return ours, jax.tree.map(np.asarray, theirs)


def test_batched_step_matches_jax(step_outputs):
    ours, theirs = step_outputs
    for name in ("path_ok", "path_too_far", "spline_budget_hit", "sorted_left_mask", "sorted_right_mask"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), getattr(theirs, name), err_msg=name)
    assert theirs.path_ok.sum() >= B // 2  # the batch exercises the full solve
    devs = [path_parity_deviation(theirs.path[b], ours.path[b].numpy()) for b in range(B)]
    assert max(devs) < LATERAL_TOL, devs


def test_batch_metrics_and_deviation_helpers(step_outputs):
    ours, theirs = step_outputs
    metrics = tbatch.batch_metrics(ours)
    assert float(metrics.n_frames) == B
    assert float(metrics.solve_success_rate) == pytest.approx(theirs.path_ok.mean())
    assert float(metrics.spline_budget_hit_rate) == pytest.approx(theirs.spline_budget_hit.mean())
    theirs_path = torch.tensor(theirs.path)
    # the port's helper measures distances to segments, the NumPy one to a
    # 4000-point densification of the polyline: never larger, and smaller by
    # at most half the densified spacing (about 2.5 mm on a 20 m path)
    on_segments = tbatch.path_parity_deviation_paths(ours.path, theirs_path).numpy()
    densified = np.array([path_parity_deviation(theirs.path[b], ours.path[b].numpy()) for b in range(B)])
    assert (on_segments <= densified + 1e-6).all(), (on_segments, densified)
    assert (densified - on_segments < 2.6e-3).all(), (on_segments, densified)
    np.testing.assert_allclose(
        tbatch.path_deviation(ours.path, theirs_path[:, :, 1:3]).numpy(),
        np.asarray(jbatch.path_deviation(ours.path.numpy(), theirs.path[:, :, 1:3])),
        atol=1e-6,
    )


def test_path_planner_matches_golden_first_40_frames(session):
    golden = np.load(GOLDEN)["paths_plain"]
    cfg = torch_config(MissionTypes.trackdrive, n_cones=256)
    planner = PathPlanner(MissionTypes.trackdrive, config=cfg, device="cpu")
    devs = []
    for i, frame in enumerate(session[:40]):
        path = planner.calculate_path_in_global_frame(*_frame_args(frame))
        assert path.shape == (40, 4) and np.isfinite(path).all()
        devs.append(path_parity_deviation(np.asarray(golden[i], np.float64), path))
    assert max(devs) < 0.05, f"max {max(devs):.4f} m at frame {int(np.argmax(devs))}"
    assert np.median(devs) < 0.01, f"median {np.median(devs):.4f} m"


def test_replay_from_jax_state_agrees(session):
    start, steps = 20, 5
    jcfg = jax_config(JMissionTypes.trackdrive, n_cones=256)
    jplanner = JPathPlanner(JMissionTypes.trackdrive, config=jcfg)
    for frame in session[:start]:
        jplanner.calculate_path_in_global_frame(*_frame_args(frame))
    captured = jax.tree.map(np.asarray, jplanner._state)

    jax_paths, jax_frames = [], []
    for frame in session[start : start + steps]:
        cones, pos, direction = _frame_args(frame)
        pts, mask = jfacade.flatten_cones_by_type(cones, jcfg.shapes.n_cones)
        jax_frames.append(
            JFrameInput(pts, mask, pos.astype(np.float32), direction.astype(np.float32))
        )
        jax_paths.append(jplanner.calculate_path_in_global_frame(cones, pos, direction))

    ours = [interop.frame_from_numpy(f, device="cpu") for f in jax_frames]
    frames = FrameInput(*(torch.stack(leaf) for leaf in zip(*ours)))  # (T, 1, ...)
    state = interop.state_from_numpy(captured, device="cpu")
    tcfg = torch_config(MissionTypes.trackdrive, n_cones=256)
    final, paths = tbatch.replay_scan(tcfg, state, frames)

    assert paths.shape == (steps, 1, 40, 4)
    devs = [path_parity_deviation(jax_paths[t], paths[t, 0].numpy()) for t in range(steps)]
    assert max(devs) < LATERAL_TOL, devs
    np.testing.assert_array_equal(final.path.prev_path[0].numpy(), paths[-1, 0].numpy())


def test_import_loads_no_jax():
    modules = [m.name for m in pkgutil.walk_packages(ft_fsd_path_planning_torch.__path__, "ft_fsd_path_planning_torch.")]
    # bench_torch.py and chip_smoke.py lie outside the package, at the root
    code = (
        "import importlib, sys\n"
        f"for name in {modules + ['bench_torch', 'chip_smoke']!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'ft_fsd_path_planning_tpu')))\n"
        "assert not bad, bad\n"
        "print('imported', len(sys.modules))\n"
    )
    # the CLI's __main__ is imported with arguments it would refuse: it must not run
    proc = subprocess.run(
        [sys.executable, "-c", code, "--no-such-flag"], cwd=REPO, check=True, timeout=120,
        capture_output=True, text=True,
    )
    assert proc.stdout.startswith("imported") and "mission:" not in proc.stdout, proc.stdout
    for name in (
        "parallel.batch", "assets.known_paths", "models.relocalization", "utils.timer", "profile_step",
        "types", "native.loader", "demo.__main__", "demo.json_demo", "demo.make_session",
        "demo.scenarios", "demo.serve", "demo.export_viz",
    ):
        assert f"ft_fsd_path_planning_torch.{name}" in modules


def test_entry_points_refuse_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = torch_config(n_cones=N)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbatch.make_batch_state(cfg, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tscen.make_frame_batch(cfg, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PathPlanner(MissionTypes.trackdrive)
    # the front doors: bench, replay CLI, plan server, viewer export
    import bench_torch
    from ft_fsd_path_planning_torch.demo import export_viz, json_demo, serve

    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_torch.run()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        json_demo.main([str(SESSION), "--max-frames", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.PlanServer(("127.0.0.1", 0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_viz.build_payload(max_session_frames=1)
    for mission in MissionTypes:  # every mission: refused without a GPU, accepted on the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PathPlanner(mission)
        planner = PathPlanner(mission, config=torch_config(mission, n_cones=N), device="cpu")
        assert planner.relocalization_info is None
        assert planner.cfg.supports_global_path == planner.cfg.has_relocalizer
