"""Spline-stack support ops: chord parameterization and banded SPD solves.

Counterpart of `ft_fsd_path_planning_tpu/ops/spline.py`. Every solve of the
FITPACK engine goes through :func:`_solve_spd_banded`: the band of the matrix
is solved by kernel B1 (`ops/banded_cholesky.py`), followed by one round of
iterative refinement. That is the arithmetic the JAX package runs on the
TPU; on the CPU the JAX package uses a dense Cholesky instead. On a CUDA
tensor the whole refined solve is one launch of the kernel's fused entry,
which reads the band out of the dense matrix itself; on a CPU tensor it is
the plain composition :func:`_banded_solve` of the band helpers.
"""

from __future__ import annotations

import torch

from ft_fsd_path_planning_torch.ops.banded_cholesky import (
    BW,
    band_matvec,
    banded_cholesky_solve,
    banded_refined_solve_cuda,
    dense_to_band,
)

Tensor = torch.Tensor


def _banded_solve(band: Tensor, rhs: Tensor) -> Tensor:
    """Solve the SPD banded systems (G, C, 9) @ x = (G, C, R) with one round
    of iterative refinement (without it, FITPACK's SSR-vs-budget decisions
    wobble enough to flip knot selection), as a composition of the bare
    solve: two solves, a band product, a difference and a sum."""
    x = banded_cholesky_solve(band, rhs)
    resid = rhs - band_matvec(band, x)
    return x + banded_cholesky_solve(band, resid)


def _solve_spd_banded(a: Tensor, b: Tensor) -> Tensor:
    """Solve SPD systems with half-bandwidth <= 4: a (..., C, C), b (..., C, R)."""
    c, r = a.shape[-1], b.shape[-1]
    rhs = b.reshape(-1, c, r).contiguous()
    if a.device.type == "cpu":
        x = _banded_solve(dense_to_band(a).reshape(-1, c, BW).contiguous(), rhs)
    else:
        x = banded_refined_solve_cuda(a.reshape(-1, c, c), rhs)
    return x.reshape(b.shape)


def chord_lengths(points: Tensor, mask: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Cumulative chord parameter of masked traces points (B, M, 2).

    Returns (u (B, M), u_max (B,), ok (B,)): u[i] is the chord position of
    point i (invalid slots repeat the running total), as the reference's
    ``u = [0, cumsum(dists)]``. ``ok`` is False when two consecutive valid
    points coincide (where splprep raises and the reference falls back to
    the previous path), or when fewer than two points are valid.
    """
    seg_valid = mask[:, 1:] & mask[:, :-1]
    d = torch.sqrt(torch.clamp(torch.sum(torch.diff(points, dim=1) ** 2, dim=-1), min=0.0))
    d = torch.where(seg_valid, d, torch.zeros_like(d))
    zero = torch.zeros_like(d[:, :1])
    u = torch.cat([zero, torch.cumsum(d, dim=1)], dim=1)
    u_max = torch.amax(torch.where(mask, u, torch.zeros_like(u)), dim=1)
    n_valid = torch.sum(mask, dim=1)
    ok = (torch.sum(seg_valid & (d <= 1e-9), dim=1) == 0) & (n_valid >= 2) & (u_max > 1e-9)
    return u, u_max, ok
