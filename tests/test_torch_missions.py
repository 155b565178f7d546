"""The relocalizer missions and the set/unset global path through both
packages' `PathPlanner` on the CPU, on the seeded sessions of
`ft_fsd_path_planning_torch/parallel/scenarios.py`.

* Skidpad, full view: the first 40 frames (relocalization on frame 0, the
  float64 refinement, entry into the first lap), then 20 frames astride the
  junction of the two right laps and 20 astride the right-to-left junction,
  the port started there from the JAX planner's state of numpy leaves
  through `interop.state_from_numpy` (so the test need not replay hundreds
  of frames through the port).
* Skidpad, partial view (only cones within 10 m): early frames fail and
  retry, the trivial path before relocalization.
* Acceleration and EBS test, 12 frames each (704-slot window, 1,024 dense
  samples); then the acceleration session through frame 23, astride frames
  20 and 22, where the JAX package's float32 dense factorization breaks down
  and it falls back to its previous path while the port's p-iteration
  retries: there the port is held against the JAX package run with a
  float64 solver (the golden tool's `float64_solver`), which does not fall
  back.
* Trackdrive with the circle set as a global path, then unset, on the same
  planner.

Bars: the same frame of first relocalization; `relocalization_info` within
1e-4 rad and 1 mm; per-frame lateral deviation under 1 cm (compared
laterally: one ulp in the pose can move the skidpad tracker's index by one
0.1 m sample along the same path). A batched step at B = 8 with relocalized
and fresh lanes against `jax.vmap` of the JAX step, lane for lane. The
committed `assets/missions_golden.npz` equals what the golden tool computes
today on a prefix of every session.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ft_fsd_path_planning_tpu import MissionTypes as JMissionTypes
from ft_fsd_path_planning_tpu import PathPlanner as JPathPlanner
from ft_fsd_path_planning_tpu.config import default_config as jax_config
from ft_fsd_path_planning_tpu.models import planner as jplanner
from ft_fsd_path_planning_tpu.parallel import batch as jbatch
from ft_fsd_path_planning_torch import MissionTypes, PathPlanner, interop
from ft_fsd_path_planning_torch.config import default_config as torch_config
from ft_fsd_path_planning_torch.parallel import batch as tbatch
from ft_fsd_path_planning_torch.parallel import scenarios as tscen
from tests.torch_parity import path_parity_deviation

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "ft_fsd_path_planning_torch/assets/missions_golden.npz"
LATERAL_TOL = 0.01
ROT_TOL, TRANS_TOL = 1e-4, 1e-3
HEAD = 40  # frames of the full-view skidpad session both facades replay from the start
JUNCTIONS = {"lap junction": 135, "right-to-left junction": 249}  # first frame of each 20-frame segment
SEGMENT = 20
SHORT = 12  # acceleration and EBS frames


def _load_tool():
    spec = importlib.util.spec_from_file_location("make_torch_missions_golden", REPO / "tools/make_torch_missions_golden.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TOOL = _load_tool()


def _planners(mission: str):
    jpl = JPathPlanner(getattr(JMissionTypes, mission), config=jax_config(getattr(JMissionTypes, mission), n_cones=TOOL.N_CONES))
    tpl = PathPlanner(getattr(MissionTypes, mission), config=torch_config(getattr(MissionTypes, mission), n_cones=TOOL.N_CONES), device="cpu")
    return jpl, tpl


def _assert_session_agrees(ours: dict, theirs: dict, label: str) -> None:
    assert int(ours["first_relocalized"]) == int(theirs["first_relocalized"]), label
    assert np.isfinite(ours["paths"]).all() and ours["paths"].shape == theirs["paths"].shape
    assert abs(float(ours["rotation"]) - float(theirs["rotation"])) < ROT_TOL, label
    np.testing.assert_allclose(ours["translation"], theirs["translation"], rtol=0, atol=TRANS_TOL, err_msg=label)
    # no package falls back to its previous path on these frames, so every frame is compared
    assert ours["path_ok"].all() and theirs["path_ok"].all(), label
    devs = [path_parity_deviation(t, o) for o, t in zip(ours["paths"], theirs["paths"])]
    assert max(devs) < LATERAL_TOL, f"{label}: max {max(devs):.4f} m at frame {int(np.argmax(devs))}"


@pytest.fixture(scope="module")
def skidpad():
    """The full-view session: both facades over the first HEAD frames; then
    the JAX facade alone over the rest, its state and paths kept at the
    junction segments."""
    frames = tscen.mission_sessions()["skidpad"][1]
    jpl, tpl = _planners("skidpad")
    theirs = TOOL.run_session(jpl, frames[:HEAD])
    ours = TOOL.run_session(tpl, frames[:HEAD])
    refined = tpl._state.reloc
    segments = {}
    for i in range(HEAD, max(JUNCTIONS.values()) + SEGMENT):
        for name, start in JUNCTIONS.items():
            if i == start:
                segments[name] = {"state": jax.tree.map(np.asarray, jpl._state), "paths": []}
        path = jpl.calculate_path_in_global_frame(*frames[i])
        for name, start in JUNCTIONS.items():
            if start <= i < start + SEGMENT:
                segments[name]["paths"].append(path)
    return frames, ours, theirs, refined, segments


def test_skidpad_first_frames_match_jax(skidpad):
    _, ours, theirs, _, _ = skidpad
    assert int(theirs["first_relocalized"]) == 0
    _assert_session_agrees(ours, theirs, "skidpad")
    assert abs(float(ours["rotation"]) + tscen.SKIDPAD_MAP_ROTATION) < 2e-3


def test_skidpad_refined_transform_is_the_float64_one_cast(skidpad):
    """After the relocalization frame the carried transform is the float32
    cast of the float64 rerun, not the step's own float32 estimate."""
    from ft_fsd_path_planning_torch.models import relocalization as treloc
    from ft_fsd_path_planning_torch.models.facade import flatten_cones_by_type

    frames, _, _, refined, _ = skidpad
    cones, pos, direction = frames[0]
    pts, mask = flatten_cones_by_type(cones, TOOL.N_CONES, dtype=np.float64)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))[None]  # noqa: E731
    ok, rot, trans, center = treloc.skidpad_relocalize_once(
        f64(pts[:, :2]), torch.as_tensor(mask)[None], f64(pos), f64(pos), f64(direction)
    )
    assert bool(ok[0])
    assert torch.equal(refined.rotation, rot.to(torch.float32))
    assert torch.equal(refined.translation, trans.to(torch.float32))
    assert torch.equal(refined.center, center.to(torch.float32))
    _, rot32, trans32, _ = treloc.skidpad_relocalize_once(
        *(t.to(torch.float32) if t.is_floating_point() else t for t in (f64(pts[:, :2]), torch.as_tensor(mask)[None], f64(pos), f64(pos), f64(direction)))
    )
    # the two estimates differ (by well under the step's tolerance), so the cast is visible
    assert not torch.equal(rot32, refined.rotation) or not torch.equal(trans32, refined.translation)
    assert float((rot32 - refined.rotation).abs()) < 2e-4


@pytest.mark.parametrize("junction", sorted(JUNCTIONS))
def test_skidpad_junction_from_jax_state(skidpad, junction):
    frames, _, _, _, segments = skidpad
    start, seg = JUNCTIONS[junction], segments[junction]
    state = interop.state_from_numpy(seg["state"], device="cpu")
    assert bool(state.reloc.relocalized[0]) and int(state.path.index_along_path[0]) > 0
    tpl = PathPlanner(MissionTypes.skidpad, config=torch_config(MissionTypes.skidpad, n_cones=TOOL.N_CONES), device="cpu")
    tpl._state, tpl._was_relocalized = state, True
    devs, indices = [], []
    for i, want in zip(range(start, start + SEGMENT), seg["paths"]):
        path = tpl.calculate_path_in_global_frame(*frames[i])
        assert path.shape == (40, 4) and np.isfinite(path).all()
        devs.append(path_parity_deviation(want, path))
        indices.append(int(tpl._state.path.index_along_path[0]))
    assert max(devs) < LATERAL_TOL, f"max {max(devs):.4f} m at frame {start + int(np.argmax(devs))}"
    # the tracker advances ~5 samples of 0.1 m a frame and never jumps laps
    steps = np.diff(indices)
    assert (steps >= 3).all() and (steps <= 7).all(), indices


def test_skidpad_partial_view_retries_then_relocalizes():
    frames = tscen.mission_sessions()["skidpad_partial"][1]
    jpl, tpl = _planners("skidpad")
    theirs, ours = TOOL.run_session(jpl, frames), TOOL.run_session(tpl, frames)
    assert 0 < int(theirs["first_relocalized"]) < len(frames)  # early frames fail and retry
    _assert_session_agrees(ours, theirs, "skidpad, partial view")


@pytest.mark.parametrize("mission", ["acceleration", "ebs_test"])
def test_acceleration_like_mission_matches_jax(mission):
    frames = tscen.mission_sessions(SHORT)[mission][1]
    jpl, tpl = _planners(mission)
    assert tpl.cfg.shapes.global_window == 704 and tpl.cfg.shapes.dense_samples == 1024
    theirs, ours = TOOL.run_session(jpl, frames), TOOL.run_session(tpl, frames)
    assert int(theirs["first_relocalized"]) == 0
    _assert_session_agrees(ours, theirs, mission)
    np.testing.assert_allclose(ours["translation"], [0.0, 0.0], atol=1e-6)
    # the path runs along the corridor, ahead of the car
    last = ours["paths"][-1]
    assert last[-1, 1] > frames[-1][1][0] + 15.0 and np.abs(last[:, 2]).max() < 0.2


def test_acceleration_hairpin_frames_match_jax_with_a_float64_solver():
    """Frames 20 and 22 of the acceleration session: the window is a hairpin
    on which the JAX package's float32 dense Cholesky breaks down, its fit
    carries NaN and it repeats its previous path (1.5 m off). The port
    retries the broken factorization with a larger p and solves the frame.
    With the solve alone done in float64 the JAX package solves it too: the
    port is held against that, on every frame from 0 through 23."""
    n = 24
    frames = tscen.mission_sessions(n)["acceleration"][1]
    golden = np.load(GOLDEN)
    assert np.nonzero(~golden["acceleration/path_ok"])[0].tolist() == [20, 22]
    theirs = TOOL.run_jax_session("acceleration", frames, float64=True)
    np.testing.assert_allclose(golden["acceleration/paths_float64_solver"][:n], theirs["paths"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(golden["acceleration/path_ok_float64_solver"][:n], theirs["path_ok"])
    assert theirs["path_ok"].all()
    tpl = _planners("acceleration")[1]
    ours = TOOL.run_session(tpl, frames)
    np.testing.assert_array_equal(ours["path_ok"], theirs["path_ok"])
    devs = np.array([path_parity_deviation(t, o) for o, t in zip(ours["paths"], theirs["paths"])])
    assert devs.max() < LATERAL_TOL, f"max {devs.max():.4f} m at frame {int(devs.argmax())}"
    # what the JAX package's own solver gives there is its previous path, far from either
    for i in (20, 22):
        assert path_parity_deviation(golden["acceleration/paths"][i], ours["paths"][i]) > 1.0
    # outside those frames the float64 solver moves the JAX package's paths by well under the bar
    rest = [i for i in range(n) if i not in (20, 22)]
    moved = [path_parity_deviation(golden["acceleration/paths"][i], theirs["paths"][i]) for i in rest]
    assert max(moved) < LATERAL_TOL, moved


def test_global_path_set_then_unset_matches_jax():
    """set_global_path flips ``supports_global_path`` and the 384-slot window
    takes over the centerline; clearing it returns to the sorting pipeline
    on the SAME planner."""
    frames = tscen.corridor_session(6)
    circle = tscen.global_path_circle()
    jpl = JPathPlanner(JMissionTypes.trackdrive, config=jax_config(JMissionTypes.trackdrive, n_cones=64))
    tpl = PathPlanner(MissionTypes.trackdrive, config=torch_config(MissionTypes.trackdrive, n_cones=64), device="cpu")
    assert tpl.relocalization_info is None and not tpl.cfg.supports_global_path
    jpl.set_global_path(circle)
    tpl.set_global_path(circle)
    assert tpl.cfg.supports_global_path and tpl.global_path is circle
    devs, with_path = [], []
    for i, frame in enumerate(frames):
        if i == 3:
            jpl.set_global_path(None)
            tpl.set_global_path(None)
            assert tpl.global_path is None and not bool(tpl._state.global_path.active[0])
        theirs, ours = jpl.calculate_path_in_global_frame(*frame), tpl.calculate_path_in_global_frame(*frame)
        devs.append(path_parity_deviation(theirs, ours))
        with_path.append(ours)
    assert max(devs) < LATERAL_TOL, devs
    # with the circle set the path bends left with it; unset, it follows the straight corridor
    assert with_path[2][-1, 2] - frames[2][1][1] > 2.0
    assert abs(with_path[5][-1, 2]) < 0.3


def test_batched_step_with_mixed_lanes_matches_jax_vmap():
    """Two batched steps at B = 8 from a fresh state: after the first some
    lanes have relocalized and some have not, so the second runs both kinds
    in one batch; relocalized lanes stay frozen."""
    b = 8
    jcfg = jax_config(JMissionTypes.skidpad, n_cones=TOOL.N_CONES)
    tcfg = torch_config(MissionTypes.skidpad, n_cones=TOOL.N_CONES)
    cones, mask, pos, direction, _ = tscen.mission_frame_batch_numpy(tcfg, b, seed=0)
    jframes = jplanner.FrameInput(jnp.asarray(cones), jnp.asarray(mask), jnp.asarray(pos), jnp.asarray(direction))
    tframes = tscen.mission_frame_batch(tcfg, b, seed=0, device="cpu")[0]
    step = jax.jit(lambda s, f: jbatch.batched_step(jcfg, s, f))
    jstate, tstate = jbatch.make_batch_state(jcfg, b), tbatch.make_batch_state(tcfg, b, device="cpu")
    for round_ in range(2):
        theirs, jstate = step(jstate, jframes)
        ours, tstate = tbatch.batched_step(tcfg, tstate, tframes)
        theirs = jax.tree.map(np.asarray, theirs)
        relocalized = theirs.relocalized
        assert 0 < relocalized.sum() < b, relocalized  # both kinds of lane
        np.testing.assert_array_equal(ours.relocalized.numpy(), relocalized)
        for name in ("path_ok", "path_too_far", "spline_budget_hit"):
            np.testing.assert_array_equal(getattr(ours, name).numpy(), getattr(theirs, name), err_msg=name)
        np.testing.assert_allclose(
            tstate.reloc.rotation.numpy()[relocalized], np.asarray(jstate.reloc.rotation)[relocalized], rtol=0, atol=2e-4
        )
        np.testing.assert_array_equal(tstate.path.index_along_path.numpy(), np.asarray(jstate.path.index_along_path))
        devs = [path_parity_deviation(theirs.path[i], ours.path[i].numpy()) for i in range(b)]
        assert max(devs) < LATERAL_TOL, (round_, devs)
        if round_ == 0:
            first = tstate.reloc
    assert torch.equal(tstate.reloc.rotation, first.rotation) and torch.equal(tstate.reloc.translation, first.translation)
    assert float(tbatch.batch_metrics(ours).relocalized_rate) == pytest.approx(relocalized.mean())
    assert ours.sorted_left.shape == (b, 12, 2) and not bool(ours.sorted_left_mask.any())
    assert ours.left_to_right.shape == (b, 32) and bool((ours.left_to_right == -1).all())


def test_batched_replay_is_replay_scan_per_lane():
    tcfg = torch_config(MissionTypes.acceleration, n_cones=64)
    frames = tscen.acceleration_session(3)
    from ft_fsd_path_planning_torch.models.facade import flatten_cones_by_type
    from ft_fsd_path_planning_torch.models.planner import FrameInput

    flat = [flatten_cones_by_type(f[0], 64) for f in frames]
    lane = FrameInput(
        cones=torch.as_tensor(np.stack([f[0] for f in flat])),
        mask=torch.as_tensor(np.stack([f[1] for f in flat])),
        position=torch.as_tensor(np.stack([f[1] for f in frames]), dtype=torch.float32),
        direction=torch.as_tensor(np.stack([f[2] for f in frames]), dtype=torch.float32),
    )
    # lane 1 drives the same frames shifted by 2 m across the track
    shifted = lane._replace(
        cones=lane.cones + torch.tensor([0.0, 2.0, 0.0]), position=lane.position + torch.tensor([0.0, 2.0])
    )
    both = FrameInput(*(torch.stack([a, b]) for a, b in zip(lane, shifted)))  # (B=2, T=3, ...)
    final, paths = tbatch.batched_replay(tcfg, tbatch.make_batch_state(tcfg, 2, device="cpu"), both)
    assert paths.shape == (2, 3, 40, 4) and bool(final.reloc.relocalized.all())
    _, alone = tbatch.replay_scan(tcfg, tbatch.make_batch_state(tcfg, 1, device="cpu"), FrameInput(*(x[:, None] for x in lane)))
    assert float((paths[0] - alone[:, 0]).abs().max()) < 1e-5
    assert float((paths[1, :, :, 2] - paths[0, :, :, 2] - 2.0).abs().max()) < 1e-3


def test_golden_file_is_what_the_tool_writes_today(skidpad):
    """The committed golden file against the JAX facade on a prefix of every
    session (the full-view skidpad prefix comes from the shared fixture)."""
    golden = np.load(GOLDEN)
    _, _, theirs, _, _ = skidpad
    fresh = {"skidpad": theirs}
    for name, (mission, frames) in tscen.mission_sessions(10).items():
        if name != "skidpad":
            fresh[name] = TOOL.run_jax_session(mission, frames)
    assert sorted({k.split("/")[0] for k in golden.files}) == sorted(fresh)
    # a second pass with the float64 solver exists for exactly the sessions with a fallback frame
    for name in fresh:
        assert (f"{name}/paths_float64_solver" in golden.files) == (not golden[f"{name}/path_ok"].all()), name
    full = {name: len(frames) for name, (_, frames) in tscen.mission_sessions().items()}
    for name, run in fresh.items():
        n = len(run["paths"])
        assert golden[f"{name}/paths"].shape == (full[name], 40, 4)
        np.testing.assert_allclose(golden[f"{name}/paths"][:n], run["paths"], rtol=0, atol=1e-5, err_msg=name)
        np.testing.assert_array_equal(golden[f"{name}/path_ok"][:n], run["path_ok"], err_msg=name)
        assert golden[f"{name}/path_ok"].shape == (full[name],)
        first = int(golden[f"{name}/first_relocalized"])
        if first < n:
            assert int(run["first_relocalized"]) == first
            assert float(run["rotation"]) == pytest.approx(float(golden[f"{name}/rotation"]), abs=1e-7)
            np.testing.assert_allclose(run["translation"], golden[f"{name}/translation"], atol=1e-6)
    assert int(golden["skidpad_partial/first_relocalized"]) > 0
