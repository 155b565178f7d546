"""Kernel B1's plain PyTorch version against the Pallas kernel and NumPy.

On the CPU the port's banded solve runs its plain version, which repeats the
CUDA kernel's arithmetic operation for operation; the kernel itself is held
against it on the card by chip_smoke.py. Tolerances:
* 2e-3 against np.linalg.solve, as tests/test_pallas_banded.py uses for the
  Pallas kernel (float32 Cholesky of diagonally dominant systems);
* 1e-5 relative against the Pallas kernel in interpret mode: the same
  recurrence in float32, differing only in rounding of the transposed
  layout's arithmetic;
* 1e-5 relative for the refined solve against JAX's `_banded_solve`, also
  for `banded_refined_solve_plain`, the plain version of the kernel's fused
  entry (dense matrix in, refined solution out);
* rtol 1e-4 / atol 1e-5 for the refined solve against np.linalg.solve in
  float64 (float32 Cholesky with one refinement round);
* equal bit for bit: `_solve_spd_banded` on the CPU against a stored case
  computed before the fused entry existed, and against
  `banded_refined_solve_plain` (the same arithmetic in the same order).
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


SHAPES = [(8, 28, 2), (7, 51, 2), (3, 20, 1)]


@pytest.mark.parametrize("b,c,r", SHAPES)
def test_refined_plain_matches_jax_banded_solve(monkeypatch, b, c, r):
    """The fused entry's plain version (dense in) against JAX's
    `_banded_solve` on the band, the Pallas kernel in interpret mode."""
    monkeypatch.setattr(
        jspline, "banded_cholesky_solve",
        functools.partial(jbc.banded_cholesky_solve, interpret=True),
    )
    mats, rhs = _systems(7 * b + c, b, c, r)
    dense = torch.tensor(mats, dtype=torch.float32)
    ours = tbc.banded_refined_solve_plain(dense, torch.tensor(rhs, dtype=torch.float32)).numpy()
    band_j = jbc.dense_to_band(jnp.asarray(mats, jnp.float32))
    theirs = np.asarray(jspline._banded_solve(band_j, jnp.asarray(rhs, jnp.float32)))
    assert np.abs(ours - theirs).max() <= 1e-5 * np.abs(theirs).max()


@pytest.mark.parametrize("b,c,r", SHAPES)
def test_refined_plain_matches_numpy_float64(b, c, r):
    mats, rhs = _systems(11 * b + c, b, c, r)
    x = tbc.banded_refined_solve_plain(
        torch.tensor(mats, dtype=torch.float32), torch.tensor(rhs, dtype=torch.float32)
    )
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(mats, rhs), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("lead", [(5,), (2, 3), ()])
def test_solve_spd_banded_is_the_refined_plain_solve(lead):
    """On the CPU `_solve_spd_banded` composes the band helpers; the fused
    entry's plain version must be that composition bit for bit, for any
    leading axes and for a matrix that is a strided view."""
    c, r = 28, 2
    n = int(np.prod(lead, dtype=int))
    mats, rhs = _systems(13 + n, n, c, r)
    a = torch.tensor(mats, dtype=torch.float32).reshape(lead + (c, c))
    b = torch.tensor(rhs, dtype=torch.float32).reshape(lead + (c, r))
    tbc.reset_launch_count()
    got = tspline._solve_spd_banded(a, b)
    assert tbc.launch_count == 0 and tbc.refined_launch_count == 0  # CPU tensors take the plain composition
    want = tbc.banded_refined_solve_plain(a.reshape(-1, c, c), b.reshape(-1, c, r)).reshape(b.shape)
    assert got.shape == b.shape and torch.equal(got, want)
    a_t = a.transpose(-1, -2)  # the same symmetric matrices through other strides
    assert not a_t.is_contiguous() or c == 1
    torch.testing.assert_close(tspline._solve_spd_banded(a_t, b), got, rtol=1e-5, atol=1e-6)


# `_solve_spd_banded` of the case below, as float32 bit patterns, computed on
# the CPU by the composition of two bare solves before the fused entry existed
_STORED_BITS = [
    [[3205259526, 1074621176], [3192920140, 1058417222], [3210765904, 3205953995],
     [3208257992, 3194776374], [1040623885, 3203576241], [1051693777, 3178119395],
     [3213866663, 3225247257], [1050120687, 3189967951], [3185493258, 3202389679],
     [1068155160, 3199535135], [3211180595, 1022146013], [1042255999, 1067019781]],
    [[1070850558, 1061046053], [1069279946, 3176258467], [3214110470, 3219867356],
     [3221709836, 3223155171], [1066917029, 3209605494], [3209815557, 3214995046],
     [3205360963, 1033157815], [1080726625, 1084909208], [1055115736, 3221613832],
     [3221480218, 1055242613], [3200545191, 3196872944], [3218288211, 1037038032]],
]


def test_solve_spd_banded_on_the_cpu_is_unchanged_bit_for_bit():
    rng = np.random.default_rng(42)
    c = 12
    low = np.zeros((2, c, c))
    for off in range(5):
        idx = np.arange(c - off)
        low[:, idx + off, idx] = rng.normal(size=(2, c - off)) * (1.0 if off == 0 else 0.3)
    a = (low @ low.transpose(0, 2, 1) + 0.5 * np.eye(c)).astype(np.float32)
    b = rng.normal(size=(2, c, 2)).astype(np.float32)
    x = tspline._solve_spd_banded(torch.tensor(a), torch.tensor(b)).numpy()
    np.testing.assert_array_equal(x.view(np.uint32), np.array(_STORED_BITS, np.uint32))


def test_refined_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    a = torch.zeros((2, 28, 28))
    rhs = torch.zeros((2, 28, 2))
    tbc.reset_launch_count()
    with pytest.raises(ValueError, match="CUDA"):
        tbc.banded_refined_solve_cuda(a, rhs)
    assert (tbc.launch_count, tbc.bare_launch_count, tbc.refined_launch_count) == (0, 0, 0)
    assert 28 <= tbc.MAX_COEFS and 51 <= tbc.MAX_COEFS and set(tbc.KERNEL_RHS) == {1, 2}


def test_cost_counters_of_both_entries():
    # band elements, right-hand sides in and solution out, float32
    assert tbc.solve_bytes(256, 28, 2) == 372736
    # the refined solve does one factorisation, two pairs of substitutions,
    # the residual and the sum: more than one bare solve, less than two plus the product
    bare, refined = tbc.solve_flops(28, 2), tbc.refined_solve_flops(28, 2)
    assert bare < refined < 2 * bare + 2 * 2 * 28 * 9 + 2 * 2 * 28
    # C = 1, R = 1: the bare solve's 4, a second multiply forward and back,
    # one product, one sum into the residual's zero, one difference, one final sum
    assert tbc.refined_solve_flops(1, 1) == 4 + 2 + 4
