"""Windowed circle-fit curvature and box filtering, masked and batched.

Counterpart of `ft_fsd_path_planning_tpu/ops/curvature.py` (reference
`path_parameterization.py:49-108, 185-193`): per-sample sliding windows are a
stack of shifted copies of the path with the dynamic window size expressed
as a validity mask over a fixed budget W, plus one masked circle fit.
"""

from __future__ import annotations

import torch

from ft_fsd_path_planning_torch.ops import gatherless as gl
from ft_fsd_path_planning_torch.ops.geometry import circle_fit, first_true

Tensor = torch.Tensor


def _rolled_windows(values: Tensor, max_window: int) -> Tensor:
    """(B, P, ...) -> (B, P, W, ...) with out[:, i, d] = values[:, (i - W//2 + d) mod P].
    Wrapped entries must be masked by the caller."""
    half = max_window // 2
    return torch.stack(
        [torch.roll(values, half - d, dims=1) for d in range(max_window)], dim=2
    )


def path_curvature(
    points: Tensor,
    n_valid: Tensor,
    window_size: Tensor,
    max_window: int,
    radius_min: float = 1.0,
    radius_max: float = 3000.0,
) -> Tensor:
    """Signed curvature at every sample of open paths.

    points (B, P, 2) with padding after n_valid (B,); window_size (B,) odd,
    <= max_window. Returns (B, P) signed curvature (1/r, sign from local
    orientation), zeros on padding.
    """
    p = points.shape[1]
    dev = points.device
    half = (window_size - 1) // 2
    shalf = max_window // 2

    centers = torch.arange(p, device=dev)[None, :, None]
    offs = torch.arange(max_window, device=dev)[None, None, :]
    raw = centers - shalf + offs  # (1, P, W)
    in_window = torch.abs(offs - shalf) <= half[:, None, None]
    nv = n_valid[:, None, None]
    valid = (raw >= 0) & (raw < nv) & in_window & (centers < nv)  # (B, P, W)
    win_pts = _rolled_windows(points, max_window)  # (B, P, W, 2)

    circ = circle_fit(win_pts, valid)  # (B, P, 3)
    radius = torch.clamp(circ[..., 2], radius_min, radius_max)
    curvature = 1.0 / radius

    # orientation sign via det of the first/mid/last window points
    first_off = first_true(valid)
    count = torch.sum(valid, dim=2)
    last_off = first_off + torch.clamp(count - 1, min=0)
    mid_off = torch.minimum(first_off + count // 2, last_off)

    def take(offsets):
        return gl.select_slot(win_pts, torch.clamp(offsets, 0, max_window - 1))

    p0, p1, p2 = take(first_off), take(mid_off), take(last_off)
    det = (p1[..., 0] - p0[..., 0]) * (p2[..., 1] - p0[..., 1]) - (p1[..., 1] - p0[..., 1]) * (
        p2[..., 0] - p0[..., 0]
    )
    signed = curvature * torch.sign(det)
    return torch.where(centers[..., 0] < n_valid[:, None], signed, torch.zeros_like(signed))


def uniform_filter1d_nearest(
    values: Tensor, n_valid: Tensor, size: Tensor, max_size: int
) -> Tensor:
    """`scipy.ndimage.uniform_filter1d(mode="nearest")` per row of values
    (B, P) with per-row size (B,): a window of ``size`` starting at offset
    -(size // 2), out-of-range indices clamped to the first/last valid
    sample."""
    p = values.shape[1]
    dev = values.device
    centers = torch.arange(p, device=dev)[None, :]
    offs = torch.arange(max_size, device=dev)[None, None, :]
    shalf = max_size // 2
    nv = n_valid[:, None]

    vals_masked = torch.where(centers < nv, values, torch.zeros_like(values))
    win = _rolled_windows(vals_masked, max_size)  # (B, P, W)

    lo_slot = (shalf - size // 2)[:, None, None]
    in_window = (offs >= lo_slot) & (offs < lo_slot + size[:, None, None])
    raw = centers[..., None] - shalf + offs
    in_range = (raw >= 0) & (raw < nv[..., None])
    body = torch.sum(torch.where(in_window & in_range, win, torch.zeros_like(win)), dim=2)

    # clamped-slot corrections: below-range slots read values[0], above-range
    # slots read values[n_valid - 1]
    sz = size[:, None]
    n_below = torch.clamp(sz // 2 - centers, min=0)
    n_below = torch.minimum(n_below, sz)
    n_above = torch.clamp(centers - sz // 2 + sz - 1 - (nv - 1), min=0)
    n_above = torch.minimum(n_above, sz)
    v_first = values[:, :1]
    v_last = gl.take_vec(values, torch.clamp(n_valid - 1, 0, p - 1)[:, None])

    out = (body + n_below * v_first + n_above * v_last) / torch.clamp(sz, min=1)
    return torch.where(centers < nv, out, torch.zeros_like(out))
