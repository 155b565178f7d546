"""The facade's sorting-result cache and the presorted step of the port
against the JAX package.

* `_cone_arrays_are_similar` and `_remap_order` on the same arrays as the JAX
  facade's: equal answers.
* `planner_step_presorted` at B = 8 on the JAX sorter's output: match index
  arrays equal, paths laterally under 1 cm (the fits run different but
  equally accurate solvers, see test_torch_fitpack.py).
* The first 64 frames of the committed session through both `PathPlanner`s
  with `experimental_performance_improvements=True`: the same hit/miss
  sequence, paths laterally under 1 cm to JAX and under 5 cm to the reference
  planner's `paths_cached`, and `return_intermediate_results=True` gives the
  JAX package's 7-tuple with equal lengths and dtypes and positions within
  1e-5 m (the same float32 arithmetic).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from ft_fsd_path_planning_tpu import MissionTypes as JMissionTypes
from ft_fsd_path_planning_tpu import PathPlanner as JPathPlanner
from ft_fsd_path_planning_tpu.config import default_config as jax_config
from ft_fsd_path_planning_tpu.models import facade as jfacade
from ft_fsd_path_planning_tpu.models import planner as jplanner
from ft_fsd_path_planning_tpu.models import sorting as js
from ft_fsd_path_planning_tpu.parallel import batch as jbatch
from ft_fsd_path_planning_tpu.parallel import scenarios as jscen
from ft_fsd_path_planning_torch import MissionTypes, PathPlanner
from ft_fsd_path_planning_torch.config import default_config as torch_config
from ft_fsd_path_planning_torch.models import facade as tfacade
from ft_fsd_path_planning_torch.models import planner as tplanner
from ft_fsd_path_planning_torch.parallel import batch as tbatch
from ft_fsd_path_planning_torch.parallel import scenarios as tscen
from tests.torch_parity import path_parity_deviation

# the port's ops are small tensors: one intra-op thread is as fast here and
# leaves the cores to the other test workers
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SESSION = REPO / "ft_fsd_path_planning_tpu/demo/closed_track_session.json"
GOLDEN = REPO / "ft_fsd_path_planning_tpu/demo/trackdrive_golden.npz"
SORT_CACHE_GOLDEN = REPO / "ft_fsd_path_planning_torch/assets/sort_cache_golden.npz"
B, N = 8, 64
N_FRAMES = 64  # past the near-threshold hit frames 18 and 58 (largest cone distance 0.09968 and 0.09952 m)
LATERAL_TOL = 0.01


def _cones(seed, n, colors=True):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-20, 20, (n, 2)).astype(np.float32)
    if not colors:
        return xy
    return np.concatenate([xy, rng.integers(0, 3, (n, 1)).astype(np.float32)], axis=1)


def _similar_cases():
    base = _cones(0, 12)
    shifted = lambda d: base + np.array([d, 0.0, 0.0], np.float32)  # noqa: E731
    recolored = base.copy()
    recolored[3, 2] = (recolored[3, 2] + 1) % 3
    xy = _cones(1, 9, colors=False)
    return {
        "none_a": (None, base),
        "none_b": (base, None),
        "shape_mismatch": (base, base[:-1]),
        "empty": (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)),
        "identical": (base, base.copy()),
        "permuted": (base, base[::-1].copy()),
        "color_mismatch": (base, recolored),
        "just_inside": (base, shifted(0.099)),
        "just_outside": (base, shifted(0.101)),
        "xy_only_inside": (xy, xy + np.float32(0.05)),
        "xy_only_outside": (xy, xy + np.float32(0.2)),
    }


SIMILAR_CASES = _similar_cases()


@pytest.mark.parametrize("case", sorted(SIMILAR_CASES))
def test_cone_arrays_are_similar_matches_jax(case):
    a, b = SIMILAR_CASES[case]
    ours = tfacade._cone_arrays_are_similar(a, b, 0.1)
    assert ours is jfacade._cone_arrays_are_similar(a, b, 0.1)
    want = case in ("empty", "identical", "permuted", "just_inside", "xy_only_inside")
    assert ours is want


@pytest.mark.parametrize("n_cached,seed", [(0, 0), (5, 1), (12, 2)])
def test_remap_order_matches_jax(n_cached, seed):
    rng = np.random.default_rng(seed)
    current = _cones(seed, 30, colors=False)
    cached = current[rng.permutation(30)[:n_cached]] + rng.normal(0, 0.02, (n_cached, 2)).astype(np.float32)
    ours = tfacade._remap_order(cached, current)
    np.testing.assert_array_equal(ours, jfacade._remap_order(cached, current))
    assert ours.shape == (n_cached, 2)
    if n_cached:
        assert np.abs(ours - cached).max() < 0.1  # each lands on its own cone


def test_planner_step_presorted_matches_jax():
    jcfg, tcfg = jax_config(n_cones=N), torch_config(n_cones=N)
    frames = jscen.make_frame_batch(jcfg, B, seed=4)
    sort = jax.jit(jax.vmap(lambda f: js.run_cone_sorting(jcfg, f.cones, f.mask, f.position, f.direction)))
    presorted = sort(frames)
    step = jax.jit(jax.vmap(lambda s, f, *p: jplanner.planner_step_presorted(jcfg, s, f, *p)))
    theirs, _ = step(jbatch.make_batch_state(jcfg, B), frames, *presorted)
    theirs = jax.tree.map(np.asarray, theirs)

    ours, state = tplanner.planner_step_presorted(
        tcfg,
        tbatch.make_batch_state(tcfg, B, device="cpu"),
        tscen.make_frame_batch(tcfg, B, seed=4, device="cpu"),
        *(torch.as_tensor(np.array(p)) for p in presorted),
    )
    for name in ("left_to_right", "right_to_left", "left_mask", "right_mask", "path_ok", "sorted_left_mask"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), getattr(theirs, name), err_msg=name)
    np.testing.assert_array_equal(ours.sorted_right.numpy(), np.asarray(presorted.right_cones))
    devs = [path_parity_deviation(theirs.path[b], ours.path[b].numpy()) for b in range(B)]
    assert max(devs) < LATERAL_TOL, devs
    assert theirs.path_ok.sum() >= B // 2
    np.testing.assert_array_equal(state.path.prev_path.numpy(), ours.path.numpy())
    with pytest.raises(ValueError, match="sorting pipeline"):
        tplanner.planner_step_presorted(
            torch_config(MissionTypes.skidpad), None, None, None, None, None, None
        )


@pytest.fixture(scope="module")
def cached_replay():
    """Both facades with the sort cache on over the first frames of the
    session, every call with return_intermediate_results=True."""
    session = json.loads(SESSION.read_bytes())[:N_FRAMES]
    jpl = JPathPlanner(
        JMissionTypes.trackdrive, True, config=jax_config(JMissionTypes.trackdrive, True, n_cones=256)
    )
    tpl = PathPlanner(
        MissionTypes.trackdrive, True, config=torch_config(MissionTypes.trackdrive, True, n_cones=256),
        device="cpu",
    )
    ours, theirs, our_hits, their_hits = [], [], [], []
    for frame in session:
        cones = [np.array(c, np.float64).reshape(-1, 2) for c in frame["slam_cones"]]
        args = (cones, np.array(frame["car_position"], np.float64), np.array(frame["car_direction"], np.float64))
        theirs.append(jpl.calculate_path_in_global_frame(*args, return_intermediate_results=True))
        ours.append(tpl.calculate_path_in_global_frame(*args, return_intermediate_results=True))
        their_hits.append(jpl.sort_cache_hits)
        our_hits.append(tpl.sort_cache_hits)
    return ours, theirs, our_hits, their_hits


def test_sort_cache_hits_the_same_frames(cached_replay):
    _, _, our_hits, their_hits = cached_replay
    assert our_hits == their_hits  # cumulative counts: the same hit/miss sequence
    assert 3 <= our_hits[-1] < N_FRAMES  # both branches ran
    # frames 18 and 58 sit within 1 mm under the 0.1 m threshold: hits here as on the card
    hit = np.diff([0] + our_hits) > 0
    assert hit[18] and hit[58], np.nonzero(hit)[0].tolist()


def test_sort_cache_golden_asset_matches_the_first_frames(cached_replay):
    """The committed hit sequence over the whole session
    (`tools/make_torch_missions_golden.py`, which chip_smoke.py compares
    with the card's replay frame by frame) agrees with both facades on the
    frames replayed here."""
    _, _, our_hits, their_hits = cached_replay
    asset = np.load(SORT_CACHE_GOLDEN)
    assert asset["hit"].shape == (300,) and asset["hit"].dtype == bool and int(asset["n_cones"]) == 256
    np.testing.assert_array_equal(asset["hit"][:N_FRAMES], np.diff([0] + their_hits) > 0)
    np.testing.assert_array_equal(asset["hit"][:N_FRAMES], np.diff([0] + our_hits) > 0)
    assert 0.2 < asset["hit"].mean() < 1.0  # the cache engages over the session, and misses too


def test_sort_cache_paths_match_jax_and_golden(cached_replay):
    ours, theirs, _, _ = cached_replay
    golden = np.load(GOLDEN)["paths_cached"]
    to_jax = [path_parity_deviation(t[0], o[0]) for o, t in zip(ours, theirs)]
    assert max(to_jax) < LATERAL_TOL, f"max {max(to_jax):.4f} m at frame {int(np.argmax(to_jax))}"
    to_golden = [path_parity_deviation(np.asarray(golden[i], np.float64), o[0]) for i, o in enumerate(ours)]
    assert max(to_golden) < 0.05, f"max {max(to_golden):.4f} m at frame {int(np.argmax(to_golden))}"
    assert np.median(to_golden) < 0.01


def test_intermediate_results_match_jax(cached_replay):
    ours, theirs, _, _ = cached_replay
    for i, (o, t) in enumerate(zip(ours, theirs)):
        assert len(o) == len(t) == 7
        for j, (a, b) in enumerate(zip(o, t)):
            assert a.shape == b.shape and a.dtype == b.dtype, (i, j, a.shape, b.shape, a.dtype, b.dtype)
        for j in (1, 2, 3, 4):  # sorted sides, sides with virtual cones
            np.testing.assert_allclose(o[j], t[j], atol=1e-5, err_msg=f"frame {i} item {j}")
        for j in (5, 6):  # match indices
            np.testing.assert_array_equal(o[j], t[j], err_msg=f"frame {i} item {j}")
    assert any(len(o[1]) >= 3 and len(o[2]) >= 3 for o in ours)


def test_plain_flag_leaves_the_cache_off():
    tpl = PathPlanner(MissionTypes.trackdrive, config=torch_config(MissionTypes.trackdrive, n_cones=64), device="cpu")
    assert not tpl._use_sort_cache and tpl.sort_cache_hits == 0
    # a global path switches the config and leaves the cache's setting alone
    circle = tscen.global_path_circle()
    tpl.set_global_path(circle)
    assert tpl.cfg.supports_global_path and not tpl._use_sort_cache
    assert int(tpl._state.global_path.n_valid[0]) == len(circle) and bool(tpl._state.global_path.active[0])
    tpl.set_global_path(None)
    assert tpl.cfg.supports_global_path and not bool(tpl._state.global_path.active[0])


def test_sort_cache_goes_on_working_with_a_global_path():
    """With the cache on and a global path set, a repeated frame hits the
    cache and takes the presorted step through the global-path branch."""
    cfg = torch_config(MissionTypes.trackdrive, True, n_cones=64)
    tpl = PathPlanner(MissionTypes.trackdrive, config=cfg, device="cpu")
    plain = PathPlanner(MissionTypes.trackdrive, config=torch_config(MissionTypes.trackdrive, n_cones=64), device="cpu")
    for planner in (tpl, plain):
        planner.set_global_path(tscen.global_path_circle())
    frame = tscen.corridor_session(1)[0]
    paths = [(tpl.calculate_path_in_global_frame(*frame), plain.calculate_path_in_global_frame(*frame)) for _ in range(3)]
    assert tpl.sort_cache_hits == 2 and tpl._use_sort_cache and tpl.cfg.supports_global_path
    for cached, uncached in paths:
        np.testing.assert_allclose(cached, uncached, rtol=0, atol=1e-5)
