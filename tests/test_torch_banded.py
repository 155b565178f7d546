"""Kernel B1's plain PyTorch version against the Pallas kernel and NumPy.

On the CPU the port's banded solve runs its plain version, which repeats the
CUDA kernel's arithmetic operation for operation; the kernel itself is held
against it on the card by chip_smoke.py. Tolerances:
* 2e-3 against np.linalg.solve, as tests/test_pallas_banded.py uses for the
  Pallas kernel (float32 Cholesky of diagonally dominant systems);
* 1e-5 relative against the Pallas kernel in interpret mode: the same
  recurrence in float32, differing only in rounding of the transposed
  layout's arithmetic;
* 1e-5 relative for the refined solve against JAX's `_banded_solve`.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ft_fsd_path_planning_tpu.ops import spline as jspline
from ft_fsd_path_planning_tpu.ops.pallas import banded_cholesky as jbc
from ft_fsd_path_planning_torch.ops import banded_cholesky as tbc
from ft_fsd_path_planning_torch.ops import spline as tspline
from tests.test_pallas_banded import make_spd_banded

# the port's ops are small tensors: one intra-op thread is as fast here and
# leaves the cores to the other test workers
torch.set_num_threads(1)


def _systems(seed, b, c, r):
    rng = np.random.default_rng(seed)
    mats = np.stack([make_spd_banded(rng, c) for _ in range(b)])
    rhs = rng.normal(size=(b, c, r))
    return mats, rhs


@pytest.mark.parametrize("b,c,r", [(7, 51, 2), (3, 20, 1), (64, 28, 2)])
def test_plain_solve_matches_pallas_and_numpy(b, c, r):
    mats, rhs = _systems(b * 100 + c, b, c, r)
    band_t = tbc.dense_to_band(torch.tensor(mats, dtype=torch.float32))
    band_j = jbc.dense_to_band(jnp.asarray(mats, jnp.float32))
    np.testing.assert_array_equal(band_t.numpy(), np.asarray(band_j))

    tbc.reset_launch_count()
    x = tbc.banded_cholesky_solve(band_t, torch.tensor(rhs, dtype=torch.float32))
    assert tbc.launch_count == 0  # CPU tensors take the plain version

    want = np.linalg.solve(mats, rhs)
    np.testing.assert_allclose(x.numpy(), want, rtol=2e-3, atol=2e-3)
    pallas = jbc.banded_cholesky_solve(band_j, jnp.asarray(rhs, jnp.float32), interpret=True)
    np.testing.assert_allclose(x.numpy(), np.asarray(pallas), rtol=1e-5, atol=1e-6)


def test_refined_solve_matches_jax(monkeypatch):
    """`_banded_solve` (solve + one refinement round) against JAX's, with the
    Pallas kernel in interpret mode: the TPU arithmetic of the JAX package."""
    monkeypatch.setattr(
        jspline, "banded_cholesky_solve",
        functools.partial(jbc.banded_cholesky_solve, interpret=True),
    )
    mats, rhs = _systems(3, 16, 28, 2)
    band = tbc.dense_to_band(torch.tensor(mats, dtype=torch.float32))
    ours = tspline._banded_solve(band, torch.tensor(rhs, dtype=torch.float32))
    theirs = jspline._banded_solve(jnp.asarray(band.numpy()), jnp.asarray(rhs, jnp.float32))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tbc.band_matvec(band, ours).numpy(),
        np.asarray(jspline._band_matvec(jnp.asarray(band.numpy()), jnp.asarray(ours.numpy()))),
        rtol=1e-6, atol=1e-5,
    )


def test_solve_spd_banded_matches_dense():
    mats, rhs = _systems(5, 4, 28, 2)
    x = tspline._solve_spd_banded(
        torch.tensor(mats, dtype=torch.float32), torch.tensor(rhs, dtype=torch.float32)
    )
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(mats, rhs), rtol=1e-4, atol=1e-5)


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    band = torch.zeros((2, 28, 9))
    rhs = torch.zeros((2, 28, 2))
    with pytest.raises(ValueError, match="CUDA"):
        tbc.banded_cholesky_solve_cuda(band, rhs)
    assert tbc.launch_count == 0


def test_solve_flops_counts_the_recurrence():
    # C = 1, R = 1: sqrt, reciprocal, one multiply forward, one back
    assert tbc.solve_flops(1, 1) == 4
    assert tbc.solve_flops(28, 2) > tbc.solve_flops(28, 1)
