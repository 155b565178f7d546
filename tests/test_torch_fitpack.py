"""ops/fitpack.py of the port against the JAX package on seeded traces.

Both packages run FITPACK's adaptive-knot algorithm in float32. The knot
decisions (interior-knot count, `budget_hit`) must be equal; knot values
agree to 1e-4 m. The JAX package on the CPU solves with a dense Cholesky,
the port with the banded recurrence plus refinement, so coefficients differ
by float32 rounding amplified by the conditioning of the normal equations.
Evaluated points inside the data span therefore agree to 1e-4 m on fits
that met their smoothing target, and to 5e-3 m on fits that stopped on the
knot budget: those carry 24 interior knots on a few dozen noisy points, and
there the JAX package's own dense and banded solvers already differ by
about 0.5 mm.

One departure, on purpose: where the p-iteration's branch 2 (p too small)
steps beyond p3, the port pulls p back inside the bracket, as FITPACK's
fpcurf.f does; the JAX package, like SciPy's Python port of the loop, does
not, and stops there on the monotonicity test. The trackdrive witness
(`tests/part2_check.py::WITNESS_POINTS`) is such a fit: the knots agree,
the port meets its smoothing target and the JAX package ends far from it.
The cases above take no such step.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ft_fsd_path_planning_tpu.ops import fitpack as jfp
from ft_fsd_path_planning_torch import PathPlanner
from ft_fsd_path_planning_torch.ops import fitpack as tfp
from ft_fsd_path_planning_torch.parallel.scenarios import skidpad_session
from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes
from ft_fsd_path_planning_torch.utils import timer
from tests import part2_check
from tests.torch_parity import seeded_traces

# the port's ops are small tensors: one intra-op thread is as fast here and
# leaves the cores to the other test workers
torch.set_num_threads(1)


def _assert_within_tolerance(ours, theirs, inside, budget_hit):
    """Per-fit max distance of evaluated points inside the data span:
    1e-4 m, or 5e-3 m for fits that stopped on the knot budget."""
    dev = np.where(inside, np.linalg.norm(ours - theirs, axis=-1), 0.0).max(axis=1)
    assert dev[~budget_hit].max(initial=0.0) < 1e-4, dev
    assert dev[budget_hit].max(initial=0.0) < 5e-3, dev


#: skidpad session frames whose fits are held to the JAX package: the
#: entry straight, both circles, the exit
SKIDPAD_FRAMES = (0, 70, 140, 210, 280, 350, 420, 540)


@functools.lru_cache(maxsize=None)
def _skidpad_fits(s: float):
    """(points, mask) of the fits with smoothing ``s`` that the port's facade
    makes on SKIDPAD_FRAMES, each frame the first of a new planner, one row
    a frame: the two fits of a frame of the benchmark cell skidpad.online
    (s = 0.01 on 256 sites, s = 0.2 on 512)."""
    frames = skidpad_session()
    rows = []
    original = tfp.fitpack_fit

    def recording(points, mask, smoothing):
        if np.float32(smoothing) == np.float32(s):
            rows.append((points.numpy().copy(), mask.numpy().copy()))
        return original(points, mask, smoothing)

    for k in SKIDPAD_FRAMES:
        planner = PathPlanner(MissionTypes.skidpad, device="cpu")
        tfp.fitpack_fit = recording
        try:
            planner.calculate_path_in_global_frame(*frames[k])
        finally:
            tfp.fitpack_fit = original
    return np.concatenate([p for p, _ in rows]), np.concatenate([m for _, m in rows])


#: (seed, s, noise) of seeded traces of 64 sites; or ("skidpad", s)
FIT_CASES = [(0, 0.2, 0.05), (1, 0.01, 0.05), (2, 0.2, 0.3), ("skidpad", 0.01), ("skidpad", 0.2)]


@pytest.fixture(scope="module", params=FIT_CASES)
def fits(request):
    seed, s, *noise = request.param
    pts, mask = _skidpad_fits(s) if seed == "skidpad" else seeded_traces(seed, 8, 64, *noise)
    ours = tfp.fitpack_fit(torch.tensor(pts), torch.tensor(mask), s)
    theirs = jax.jit(jax.vmap(lambda p, m: jfp.fitpack_fit(p, m, s)))(pts, mask)
    return pts, mask, ours, jax.tree.map(np.asarray, theirs)


def test_knot_decisions_are_equal(fits):
    _, _, ours, theirs = fits
    np.testing.assert_array_equal(ours.n_int.numpy(), theirs.n_int)
    np.testing.assert_array_equal(ours.budget_hit.numpy(), theirs.budget_hit)
    np.testing.assert_array_equal(ours.ok.numpy(), theirs.ok)
    live = np.arange(tfp.MAX_INT)[None, :] < theirs.n_int[:, None]
    np.testing.assert_allclose(
        np.where(live, ours.t_int.numpy(), 0.0), np.where(live, theirs.t_int, 0.0), atol=1e-4
    )


def test_coefficients_and_evaluation_agree(fits):
    pts, mask, ours, theirs = fits
    np.testing.assert_allclose(ours.coef.numpy(), theirs.coef, atol=5e-3)
    u = np.tile(np.arange(0, 120, 0.1, dtype=np.float32)[None], (pts.shape[0], 1))
    ev_t = tfp.fitpack_eval(ours, torch.tensor(u)).numpy()
    ev_j = np.asarray(jax.vmap(jfp.fitpack_eval)(jfp.FpSpline(*theirs), u))
    _assert_within_tolerance(ev_t, ev_j, u <= theirs.u_max[:, None], theirs.budget_hit)


def test_eval_every_matches(fits):
    _, _, ours, theirs = fits
    pts_t, grid_t, valid_t = tfp.fitpack_eval_every(ours, 0.1, 256)
    pts_j, grid_j, valid_j = jax.vmap(lambda f: jfp.fitpack_eval_every(f, 0.1, 256))(
        jfp.FpSpline(*theirs)
    )
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    np.testing.assert_array_equal(grid_t.numpy(), np.asarray(grid_j))
    _assert_within_tolerance(pts_t.numpy(), np.asarray(pts_j), np.asarray(valid_j), theirs.budget_hit)


def test_witness_departs_from_the_jax_package_where_fitpack_keeps_its_bracket():
    points, mask = part2_check.witness_fit_inputs()
    s = part2_check.WITNESS_S
    ours = tfp.fitpack_fit(points, mask, s)
    theirs = jax.tree.map(np.asarray, jax.jit(jax.vmap(lambda p, m: jfp.fitpack_fit(p, m, s)))(points.numpy(), mask.numpy()))
    # part 1 agrees: the same knots
    np.testing.assert_array_equal(ours.n_int.numpy(), theirs.n_int)
    n = int(theirs.n_int[0])
    np.testing.assert_allclose(ours.t_int.numpy()[0, :n], theirs.t_int[0, :n], atol=1e-4)
    # part 2 departs: the port converges, the JAX package stops unconverged
    acc = tfp.TOL * s
    assert abs(float(part2_check.fit_fp(ours, points, mask)[0]) - s) <= acc
    fp_jax = float(part2_check.fit_fp(tfp.FpSpline(*(torch.tensor(a) for a in theirs)), points, mask)[0])
    assert fp_jax < s - 100 * acc


def test_loop_syncs_are_counted():
    pts, mask = seeded_traces(3, 4, 32)
    tfp.loop_syncs = 0
    tfp.fitpack_fit(torch.tensor(pts), torch.tensor(mask), 0.2)
    # at least the part-1 entry check and the part-2 gate
    assert tfp.loop_syncs >= 2


# --- part 2: the plain version of the CUDA kernel (csrc/fitpack_part2.cu) ---


def _part2_args(seed: int, s: float, m: int, live):
    """The arguments fitpack_fit hands part 2 on seeded traces, captured."""
    pts, mask = seeded_traces(seed, 6, m, 0.05, live)
    seen = []
    original = tfp.fitpack_part2_plain

    def recording(*args):
        seen.append(args)
        return original(*args)

    tfp.fitpack_part2_plain = recording
    try:
        tfp.fitpack_fit(torch.tensor(pts), torch.tensor(mask), s)
    finally:
        tfp.fitpack_part2_plain = original
    (args,) = seen
    return args


def _lane(args, i):
    return tuple(a[i : i + 1] if isinstance(a, torch.Tensor) else a for a in args)


@pytest.mark.parametrize("seed,s,m,live", [(5, 0.01, 256, (166, 204)), (6, 0.2, 512, (25, 89))])
def test_part2_trips_add_up_to_the_root_rati_counter(seed, s, m, live):
    args = _part2_args(seed, s, m, live)
    timer.reset()
    with timer.recording():
        coef, trips = tfp.fitpack_part2_plain(*args)
        singles = [tfp.fitpack_part2_plain(*_lane(args, i)) for i in range(args[2].shape[0])]
    table = timer.table()
    timer.reset()
    one_by_one = sum(int(t) for _, t in singles)
    # at B = 1 a lane's trips are its loop's checks; a batch checks until
    # its slowest lane ends
    assert table["fitpack.trips.root_rati"] == int(trips.max()) + one_by_one
    assert one_by_one == int(trips.sum()) > 0
    for i, (c, t) in enumerate(singles):
        assert int(t) == int(trips[i])
        torch.testing.assert_close(c[0], coef[i], rtol=0, atol=1e-4)


def test_part2_gated_lanes_return_the_lsq_spline():
    args = list(_part2_args(7, 0.2, 64, (30, 60)))
    u, points, mask, t_int, n_int, u_max, c_lsq, fp0, fp_lsq, s, acc = args
    n_int = n_int.clone()
    fp_lsq = fp_lsq.clone()
    n_int[1] = 0  # no interior knot
    fp_lsq[2] = s + 0.5 * acc  # the LSQ spline within acc of s
    _, trips_before = tfp.fitpack_part2_plain(*args)
    assert int(trips_before[0]) > 0  # lane 0 runs the p-iteration
    coef, trips = tfp.fitpack_part2_plain(u, points, mask, t_int, n_int, u_max, c_lsq, fp0, fp_lsq, s, acc)
    for i in (1, 2):
        assert torch.equal(coef[i], c_lsq[i]) and int(trips[i]) == 0
    assert not torch.equal(coef[0], c_lsq[0])
    # a batch of gated lanes alone makes no trip and no solve
    gated = _lane((u, points, mask, t_int, n_int, u_max, c_lsq, fp0, fp_lsq, s, acc), 1)
    coef1, trips1 = tfp.fitpack_part2_plain(*gated)
    assert torch.equal(coef1, c_lsq[1:2]) and int(trips1[0]) == 0
