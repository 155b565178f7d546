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
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ft_fsd_path_planning_tpu.ops import fitpack as jfp
from ft_fsd_path_planning_torch.ops import fitpack as tfp
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


@pytest.fixture(scope="module", params=[(0, 0.2, 0.05), (1, 0.01, 0.05), (2, 0.2, 0.3)])
def fits(request):
    seed, s, noise = request.param
    pts, mask = seeded_traces(seed, 8, 64, noise)
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


def test_loop_syncs_are_counted():
    pts, mask = seeded_traces(3, 4, 32)
    tfp.loop_syncs = 0
    tfp.fitpack_fit(torch.tensor(pts), torch.tensor(mask), 0.2)
    # at least the part-1 entry check and the part-2 gate
    assert tfp.loop_syncs >= 2
