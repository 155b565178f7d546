"""The global-path branch and the skidpad override of the port's path
calculation against the JAX package's, stage by stage.

* `_global_path_centerline` (the rolled 30 m window of a global path, 384
  slots, and 704 on the acceleration missions) and `_skidpad_path_update`
  (windowed tracking along the known skidpad path with the carried index,
  and the trivial path before relocalization) on the JAX package's own
  known-path buffers and seeded poses: the same rows, masks and indices.
* FITPACK fits of those centerlines (384 and 704 input points) and the refit
  of their 1,024 dense samples: knot counts equal, evaluated points within
  0.5 mm (5 mm where a fit stops on its knot budget, as in
  test_torch_fitpack.py; that file's 0.1 mm is for 64 points within 100 m,
  here up to 620 points enter a normal equation and the acceleration path
  reaches x = 150 m, where one float32 ulp is 15 um).
* `run_path_calculation` with an active global path at both sizes, with an
  inactive one, and the skidpad branch: paths laterally within 1 cm.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ft_fsd_path_planning_tpu.config import default_config as jax_config
from ft_fsd_path_planning_tpu.models import pathing as jpathing
from ft_fsd_path_planning_tpu.models import planner as jplanner
from ft_fsd_path_planning_tpu.ops import fitpack as jfp
from ft_fsd_path_planning_tpu.utils.mission_types import MissionTypes as JMissionTypes
from ft_fsd_path_planning_torch.config import default_config as torch_config
from ft_fsd_path_planning_torch.models import pathing as tpathing
from ft_fsd_path_planning_torch.models import planner as tplanner
from ft_fsd_path_planning_torch.ops import fitpack as tfp
from ft_fsd_path_planning_torch.parallel import scenarios as tscen
from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes
from tests.torch_parity import path_parity_deviation

torch.set_num_threads(1)

LATERAL_TOL = 0.01
CPU = torch.device("cpu")


def _cfgs(mission: str, **kw):
    return jax_config(getattr(JMissionTypes, mission), **kw), torch_config(getattr(MissionTypes, mission), **kw)


def _user_buffer(path: np.ndarray) -> jpathing.GlobalPathBuffer:
    g = jplanner.GLOBAL_PATH_BUFFER_LEN
    pts = np.zeros((g, 2), np.float32)
    pts[: len(path)] = path
    return jpathing.GlobalPathBuffer(jnp.asarray(pts), jnp.asarray(len(path), jnp.int32), jnp.asarray(True))


def _torch_buffer(gp, batch: int, active=None) -> tpathing.GlobalPathBuffer:
    active = torch.full((batch,), bool(gp.active)) if active is None else torch.as_tensor(active)
    return tpathing.GlobalPathBuffer(
        points=torch.as_tensor(np.array(gp.points))[None].expand(batch, -1, -1),
        n_valid=torch.full((batch,), int(gp.n_valid), dtype=torch.int32),
        active=active,
    )


def _poses(path: np.ndarray, seed: int, batch: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Seeded poses near ``path``: (positions (B, 2) f32, directions (B, 2)
    f32, path indices (B,))."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(path) - 12, batch)
    heading = path[idx + 10] - path[idx]
    heading /= np.linalg.norm(heading, axis=1, keepdims=True)
    pos = path[idx] + rng.normal(0.0, 0.15, (batch, 2))
    return pos.astype(np.float32), heading.astype(np.float32), idx


def _centerline_case(name: str):
    """(jax cfg, torch cfg, jax global-path buffer, positions, directions)."""
    if name == "circle, 384 slots":
        jcfg, tcfg = _cfgs("trackdrive", n_cones=64, supports_global_path=True)
        path = tscen.global_path_circle()
        gp = _user_buffer(path)
    elif name == "acceleration, 704 slots":
        jcfg, tcfg = _cfgs("acceleration", n_cones=64)
        gp = jplanner._known_global_path(jcfg)
        path = np.asarray(gp.points)[:700].astype(np.float64)  # the outbound leg
    else:
        jcfg, tcfg = _cfgs("skidpad", n_cones=64)
        gp = jplanner._known_global_path(jcfg)
        path = np.asarray(gp.points)[: int(gp.n_valid)].astype(np.float64)
    pos, direction, idx = _poses(path, 3, 6)
    return jcfg, tcfg, gp, pos, direction, idx


CENTERLINE_CASES = ["circle, 384 slots", "acceleration, 704 slots", "skidpad, 384 slots"]


@pytest.mark.parametrize("case", CENTERLINE_CASES)
def test_global_path_centerline_rows_equal(case):
    jcfg, tcfg, gp, pos, _, _ = _centerline_case(case)
    assert tcfg.shapes.global_window == jcfg.shapes.global_window == (704 if "704" in case else 384)
    theirs_pts, theirs_mask = jax.vmap(lambda p: jpathing._global_path_centerline(jcfg, gp, p))(pos)
    ours_pts, ours_mask = tpathing._global_path_centerline(tcfg, _torch_buffer(gp, len(pos)), torch.as_tensor(pos))
    theirs_mask = np.asarray(theirs_mask)
    np.testing.assert_array_equal(ours_mask.numpy(), theirs_mask)
    assert ours_pts.shape == (len(pos), tcfg.shapes.global_window, 2)
    np.testing.assert_array_equal(
        np.where(theirs_mask[..., None], ours_pts.numpy(), 0.0), np.where(theirs_mask[..., None], np.asarray(theirs_pts), 0.0)
    )
    assert theirs_mask.sum(axis=1).min() > 100  # a real window, not a degenerate one
    if "704" in case:
        assert theirs_mask.sum(axis=1).max() > 384  # more than the default window would hold


@pytest.mark.parametrize("case", CENTERLINE_CASES[:2])
def test_fits_at_the_global_path_sizes_agree(case):
    """The first fit at 384 / 704 input points and the refit of 1,024 dense
    samples: knot decisions equal, evaluated points close."""
    jcfg, tcfg, gp, pos, _, _ = _centerline_case(case)
    pts, mask = jax.vmap(lambda p: jpathing._global_path_centerline(jcfg, gp, p))(pos)
    pts, mask = np.where(np.asarray(mask)[..., None], np.asarray(pts), 0.0), np.asarray(mask)

    def both(points, valid, s):
        ours = tfp.fitpack_fit(torch.tensor(points), torch.tensor(valid), s)
        theirs = jax.jit(jax.vmap(lambda p, m: jfp.fitpack_fit(p, m, s)))(points, valid)
        theirs = jax.tree.map(np.asarray, theirs)
        np.testing.assert_array_equal(ours.n_int.numpy(), theirs.n_int)
        np.testing.assert_array_equal(ours.budget_hit.numpy(), theirs.budget_hit)
        ev_t, _, valid_t = tfp.fitpack_eval_every(ours, 0.1, 1024)
        ev_j, _, valid_j = jax.vmap(lambda f: jfp.fitpack_eval_every(f, 0.1, 1024))(jfp.FpSpline(*theirs))
        np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
        dev = np.linalg.norm(ev_t.numpy() - np.asarray(ev_j), axis=-1).max(axis=1)
        assert dev[~theirs.budget_hit].max(initial=0.0) < 5e-4, dev
        assert dev[theirs.budget_hit].max(initial=0.0) < 5e-3, dev
        return np.asarray(ev_j), np.asarray(valid_j), theirs

    dense, dense_valid, first = both(pts, mask, 0.2)
    assert (first.n_int > 0).any()  # the window bends: the fits place knots
    assert dense_valid.sum(axis=1).max() > (512 if "704" in case else 256)
    both(dense, dense_valid, 0.2)


def _skidpad_update_inputs():
    jcfg, tcfg, gp, pos, direction, idx = _centerline_case("skidpad, 384 slots")
    rng = np.random.default_rng(7)
    # carried indices: near the pose, far behind it (outside the window), zero
    carried = np.stack([idx + rng.integers(-8, 8, len(idx)), np.maximum(idx - 400, 0), np.zeros_like(idx)]).astype(np.int32)
    return jcfg, tcfg, gp, pos, direction, carried


@pytest.mark.parametrize("active", [True, False], ids=["relocalized", "before relocalization"])
def test_skidpad_path_update_matches_jax(active):
    jcfg, tcfg, gp, pos, direction, carried = _skidpad_update_inputs()
    gp = gp._replace(active=jnp.asarray(active))
    prev = np.zeros((40, 4), np.float32)
    for row in carried:
        theirs = jax.vmap(
            lambda i, p, d: jpathing._skidpad_path_update(jcfg, gp, jpathing.PathState(jnp.asarray(prev), i), p, d)
        )(row, pos, direction)
        state = tpathing.PathState(torch.zeros(len(pos), 40, 4), torch.as_tensor(row))
        dense, n_dense, new_index = tpathing._skidpad_path_update(
            tcfg, _torch_buffer(gp, len(pos)), state, torch.as_tensor(pos), torch.as_tensor(direction)
        )
        np.testing.assert_array_equal(new_index.numpy(), np.asarray(theirs[3]))
        np.testing.assert_array_equal(n_dense.numpy(), np.asarray(theirs[1]))
        assert new_index.dtype == torch.int32
        if active:
            np.testing.assert_array_equal(dense.numpy(), np.asarray(theirs[0]))  # rows of the known path
            assert (n_dense.numpy() > 200).all()
        else:
            np.testing.assert_allclose(dense.numpy(), np.asarray(theirs[0]), rtol=0, atol=1e-5)  # rotated chord
            np.testing.assert_array_equal(new_index.numpy(), row)
            assert (n_dense.numpy() == 39).all()


def test_skidpad_path_update_mixed_lanes():
    """A batch of relocalized and fresh lanes gives each lane its own branch."""
    _, tcfg, gp, pos, direction, carried = _skidpad_update_inputs()
    state = tpathing.PathState(torch.zeros(len(pos), 40, 4), torch.as_tensor(carried[0]))
    args = (state, torch.as_tensor(pos), torch.as_tensor(direction))
    on = tpathing._skidpad_path_update(tcfg, _torch_buffer(gp, len(pos), [True] * 6), *args)
    off = tpathing._skidpad_path_update(tcfg, _torch_buffer(gp, len(pos), [False] * 6), *args)
    lanes = [True, False, True, True, False, False]
    mixed = tpathing._skidpad_path_update(tcfg, _torch_buffer(gp, len(pos), lanes), *args)
    for lane, active in enumerate(lanes):
        for got, a, b in zip(mixed, on, off):
            assert torch.equal(got[lane], (a if active else b)[lane])


def _path_inputs(tcfg, pos, direction):
    """Empty sorting and matching outputs, as the relocalizer branch passes
    them, in both packages' forms."""
    s = tcfg.shapes.side_len
    b = len(pos)
    jinp = jpathing.PathInput(
        jnp.zeros((b, s, 2)), jnp.zeros((b, s), bool), jnp.zeros((b, s, 2)), jnp.zeros((b, s), bool),
        jnp.full((b, s), -1, jnp.int32), jnp.full((b, s), -1, jnp.int32), jnp.asarray(pos), jnp.asarray(direction),
    )
    tinp = tpathing.PathInput(
        torch.zeros(b, s, 2), torch.zeros(b, s, dtype=torch.bool), torch.zeros(b, s, 2), torch.zeros(b, s, dtype=torch.bool),
        torch.full((b, s), -1, dtype=torch.int32), torch.full((b, s), -1, dtype=torch.int32),
        torch.as_tensor(pos), torch.as_tensor(direction),
    )
    return jinp, tinp


@pytest.mark.parametrize("case", CENTERLINE_CASES + ["circle, inactive"])
def test_run_path_calculation_with_a_global_path(case):
    jcfg, tcfg, gp, pos, direction, idx = _centerline_case("circle, 384 slots" if case == "circle, inactive" else case)
    if case == "circle, inactive":
        gp = gp._replace(active=jnp.asarray(False))
    b = len(pos)
    jinp, tinp = _path_inputs(tcfg, pos, direction)
    jstates = jax.tree.map(lambda x: jnp.broadcast_to(x, (b,) + x.shape), jpathing.initial_path_state(jcfg))
    if "skidpad" in case:
        jstates = jstates._replace(index_along_path=jnp.asarray(idx, jnp.int32))
    theirs = jax.jit(jax.vmap(lambda i, s: jpathing.run_path_calculation(jcfg, i, gp, s)))(jinp, jstates)
    theirs = jax.tree.map(np.asarray, theirs)

    tstate = tpathing.initial_path_state(tcfg, b, CPU)
    if "skidpad" in case:
        tstate = tstate._replace(index_along_path=torch.as_tensor(idx, dtype=torch.int32))
    ours = tpathing.run_path_calculation(tcfg, tinp, _torch_buffer(gp, b), tstate)

    for name in ("ok", "too_far", "spline_budget_hit", "centerline_mask"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), getattr(theirs, name), err_msg=name)
    assert ours.centerline.shape == theirs.centerline.shape
    if case == "circle, inactive":  # the previous path, each package's own initial fit
        np.testing.assert_allclose(ours.centerline.numpy(), theirs.centerline, rtol=0, atol=1e-4)
    else:  # rows of the global path
        np.testing.assert_array_equal(ours.centerline.numpy(), theirs.centerline)
    np.testing.assert_array_equal(ours.state.index_along_path.numpy(), theirs.state.index_along_path)
    devs = [path_parity_deviation(theirs.path[i], ours.path[i].numpy()) for i in range(b)]
    assert max(devs) < LATERAL_TOL, devs
    if case != "circle, inactive":
        assert theirs.ok.all()  # the global path gives a full solve on every pose
        # the path starts at the car and follows the global path
        start = np.linalg.norm(ours.path[:, 0, 1:3].numpy() - pos, axis=1)
        assert start.max() < 0.6, start


def test_hairpin_fit_survives_a_broken_factorization(monkeypatch):
    """The acceleration window at x = 16.5 m is a 118 m hairpin (return leg,
    cross leg, forward leg). Its smoothing fit starts the p-iteration at a p
    so small that the float32 band factorization of G + D^T D / p^2 breaks
    down (the JAX package's banded solver gives NaN coefficients there too;
    its dense Cholesky on the CPU survives). The port retries with a larger
    p: the fit is finite, places the JAX package's knots and lies on its
    spline."""
    jcfg, tcfg = _cfgs("acceleration", n_cones=64)
    gp = jplanner._known_global_path(jcfg)
    pos = np.array([[16.5, 0.0]], np.float32)
    pts, mask = tpathing._global_path_centerline(tcfg, _torch_buffer(gp, 1), torch.as_tensor(pos))
    pts = torch.where(mask[..., None], pts, torch.zeros_like(pts))
    assert int(mask.sum()) > 550

    broke = []
    solve = tfp._solve_spd_banded

    def watching(a, b):
        x = solve(a, b)
        broke.append(not bool(torch.isfinite(x).all()))
        return x

    monkeypatch.setattr(tfp, "_solve_spd_banded", watching)
    ours = tfp.fitpack_fit(pts, mask, 0.2)
    assert any(broke)  # the case does break a factorization down
    assert bool(torch.isfinite(ours.coef).all()) and bool(ours.ok[0])

    theirs = jax.jit(lambda p, m: jfp.fitpack_fit(p, m, 0.2))(pts[0].numpy(), mask[0].numpy())
    assert int(ours.n_int[0]) == int(theirs.n_int) > 8
    ev_t, _, valid = tfp.fitpack_eval_every(ours, 0.1, 1024)
    ev_j, _, _ = jfp.fitpack_eval_every(theirs, 0.1, 1024)
    dev = np.linalg.norm(ev_t[0].numpy() - np.asarray(ev_j), axis=-1)[valid[0].numpy()]
    assert dev.max() < 2e-3, dev.max()
