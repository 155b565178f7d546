"""Batched 2-D geometry, the PyTorch counterpart of
`ft_fsd_path_planning_tpu/ops/geometry.py`.

Every function broadcasts over leading batch axes and repeats the JAX
arithmetic in the same order, so the two packages agree to float32 rounding.
"""

from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor

_EPS = 1e-12


def deg2rad(deg: float) -> float:
    """float32 ``deg * (pi / 180)`` as `jnp.deg2rad` computes it."""
    return float(np.float32(deg) * np.float32(np.pi / 180))


def vec_dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1)


def norm_last_axis(a: Tensor) -> Tensor:
    return torch.sqrt(torch.clamp(vec_dot(a, a), min=0.0))


def normalize_last_axis(a: Tensor) -> Tensor:
    """Unit vectors; zero vectors map to zero."""
    n = norm_last_axis(a)
    return a / torch.clamp(n, min=_EPS)[..., None]


def vec_angle_between(a: Tensor, b: Tensor) -> Tensor:
    """Angle in [0, pi] between vectors of the last axis."""
    cos_theta = vec_dot(a, b) / torch.clamp(norm_last_axis(a) * norm_last_axis(b), min=_EPS)
    return torch.arccos(torch.clamp(cos_theta, -1.0, 1.0))


def rotate(points: Tensor, theta: Tensor | float) -> Tensor:
    """Rotate points (..., 2) by angle(s) theta around the origin."""
    theta = torch.as_tensor(theta, dtype=points.dtype, device=points.device)
    c, s = torch.cos(theta), torch.sin(theta)
    x, y = points[..., 0], points[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def angle_from_2d_vector(v: Tensor) -> Tensor:
    return torch.atan2(v[..., 1], v[..., 0])


def unit_2d_vector_from_angle(rad: Tensor) -> Tensor:
    return torch.stack([torch.cos(rad), torch.sin(rad)], dim=-1)


def angle_difference(angle1: Tensor, angle2: Tensor) -> Tensor:
    """Wrapped difference in [-pi, pi); order matters."""
    return torch.remainder(angle1 - angle2 + 3 * math.pi, 2 * math.pi) - math.pi


def cdist_sq(a: Tensor, b: Tensor) -> Tensor:
    """Pairwise squared distances (..., M, K) x (..., N, K) -> (..., M, N)."""
    a2 = torch.sum(a * a, dim=-1)[..., :, None]
    b2 = torch.sum(b * b, dim=-1)[..., None, :]
    ab = torch.matmul(a, b.transpose(-1, -2))
    return torch.clamp(a2 + b2 - 2.0 * ab, min=0.0)


def trace_distance_to_next(trace: Tensor) -> Tensor:
    return norm_last_axis(torch.diff(trace, dim=-2))


def trace_angles_between(trace: Tensor) -> Tensor:
    to_next = torch.diff(trace, dim=-2)
    mid_to_next = to_next[..., 1:, :]
    mid_to_prev = -to_next[..., :-1, :]
    return vec_angle_between(mid_to_next, mid_to_prev)


def points_inside_ellipse(
    points: Tensor,
    center: Tensor,
    major_direction: Tensor,
    major_radius: float,
    minor_radius: float,
) -> Tensor:
    """Points (B, N, 2) strictly inside the ellipse of each batch row
    (center, major_direction: (B, 2))."""
    centered = points - center[..., None, :]
    angle = torch.atan2(major_direction[..., 1], major_direction[..., 0])
    rotated = rotate(centered, -angle[..., None])
    crit = (rotated[..., 0] / major_radius) ** 2 + (rotated[..., 1] / minor_radius) ** 2
    return crit < 1.0


def lerp(values: Tensor, start1: Tensor, stop1: Tensor, start2: Tensor, stop2: Tensor) -> Tensor:
    return (values - start1) / (stop1 - start1) * (stop2 - start2) + start2


def circle_fit(points: Tensor, mask: Tensor | None = None, max_iter: int = 32) -> Tensor:
    """Masked hyper-fit circle estimation -> [cx, cy, r] over (..., P, 2).

    The Newton iteration on the characteristic polynomial freezes each lane
    once it stops improving; the loop ends as soon as every lane has frozen
    (one host sync per iteration), which gives the same result as running
    all ``max_iter`` trips.
    """
    if mask is None:
        w = torch.ones(points.shape[:-1], dtype=points.dtype, device=points.device)
    else:
        w = mask.to(points.dtype)
    n = torch.clamp(torch.sum(w, dim=-1), min=1.0)

    mean = torch.sum(points * w[..., None], dim=-2) / n[..., None]
    xc = points[..., 0] - mean[..., 0:1]
    yc = points[..., 1] - mean[..., 1:2]
    zi = xc * xc + yc * yc

    def m(p, q):
        return torch.sum(p * q * w, dim=-1) / n

    mxy = m(xc, yc)
    mxx = m(xc, xc)
    myy = m(yc, yc)
    mxz = m(xc, zi)
    myz = m(yc, zi)
    mzz = m(zi, zi)

    mz = mxx + myy
    cov_xy = mxx * myy - mxy * mxy
    var_z = mzz - mz * mz

    a2 = 4 * cov_xy - 3 * mz * mz - mzz
    a1 = var_z * mz + 4.0 * cov_xy * mz - mxz * mxz - myz * myz
    a0 = mxz * (mxz * myy - myz * mxy) + myz * (myz * mxx - mxz * mxy) - var_z * cov_xy
    a22 = a2 + a2

    x = torch.zeros_like(a0)
    y = a0
    done = torch.zeros_like(a0, dtype=torch.bool)
    for _ in range(max_iter):
        dy = a1 + x * (a22 + 16.0 * x * x)
        x_new = x - y / torch.where(dy == 0, torch.ones_like(dy), dy)
        y_new = a0 + x_new * (a1 + x_new * (a2 + 4.0 * x_new * x_new))
        stop = (x_new == x) | ~torch.isfinite(x_new) | (torch.abs(y_new) >= torch.abs(y))
        freeze = done | stop
        x = torch.where(freeze, x, x_new)
        y = torch.where(freeze, y, y_new)
        done = freeze
        if bool(done.all()):
            break

    det = x * x - x * mz + cov_xy
    # clamp |det| >= eps keeping its sign (sign 0 counts as +)
    det_sign = torch.where(det < 0, -1.0, 1.0).to(det.dtype)
    det = det_sign * torch.clamp(torch.abs(det), min=_EPS)
    xc_center = (mxz * (myy - x) - myz * mxy) / det / 2.0
    yc_center = (myz * (mxx - x) - mxz * mxy) / det / 2.0

    cx = xc_center + mean[..., 0]
    cy = yc_center + mean[..., 1]
    r = torch.sqrt(torch.abs(xc_center**2 + yc_center**2 + mz))
    return torch.stack([cx, cy, r], dim=-1)


def segments_intersect(
    a_start: Tensor, a_end: Tensor, b_start: Tensor, b_end: Tensor, eps: float = 1e-6
) -> Tensor:
    """Proper segment-segment intersection test with collinear touching,
    broadcasting over batch axes."""

    def orient(p, q, r):
        return (q[..., 0] - p[..., 0]) * (r[..., 1] - p[..., 1]) - (
            q[..., 1] - p[..., 1]
        ) * (r[..., 0] - p[..., 0])

    d1 = orient(b_start, b_end, a_start)
    d2 = orient(b_start, b_end, a_end)
    d3 = orient(a_start, a_end, b_start)
    d4 = orient(a_start, a_end, b_end)

    proper = ((d1 > eps) & (d2 < -eps) | (d1 < -eps) & (d2 > eps)) & (
        (d3 > eps) & (d4 < -eps) | (d3 < -eps) & (d4 > eps)
    )

    def on_segment(p, q, r):
        within_x = (r[..., 0] >= torch.minimum(p[..., 0], q[..., 0]) - eps) & (
            r[..., 0] <= torch.maximum(p[..., 0], q[..., 0]) + eps
        )
        within_y = (r[..., 1] >= torch.minimum(p[..., 1], q[..., 1]) - eps) & (
            r[..., 1] <= torch.maximum(p[..., 1], q[..., 1]) + eps
        )
        return within_x & within_y

    collinear_touch = (
        (torch.abs(d1) <= eps) & on_segment(b_start, b_end, a_start)
        | (torch.abs(d2) <= eps) & on_segment(b_start, b_end, a_end)
        | (torch.abs(d3) <= eps) & on_segment(a_start, a_end, b_start)
        | (torch.abs(d4) <= eps) & on_segment(a_start, a_end, b_end)
    )
    return proper | collinear_touch


def polyline_self_intersections(points: Tensor, mask: Tensor) -> Tensor:
    """Count intersecting non-adjacent segment pairs of a masked polyline
    (..., L, 2) / (..., L)."""
    a_start = points[..., :-1, :]
    a_end = points[..., 1:, :]
    seg_ok = mask[..., :-1] & mask[..., 1:]
    hit = segments_intersect(
        a_start[..., :, None, :],
        a_end[..., :, None, :],
        a_start[..., None, :, :],
        a_end[..., None, :, :],
    )
    m = points.shape[-2] - 1
    i = torch.arange(m, device=points.device)
    non_adjacent = torch.abs(i[:, None] - i[None, :]) > 1
    pair_ok = seg_ok[..., :, None] & seg_ok[..., None, :] & non_adjacent
    return torch.sum(hit & pair_ok, dim=(-2, -1)) // 2


def masked_median(values: Tensor, mask: Tensor) -> Tensor:
    """Median over the masked elements of the last axis (np.median semantics,
    including the even-count mean); empty rows give float32 max."""
    big = torch.finfo(values.dtype).max
    filled = torch.where(mask, values, torch.full_like(values, big))
    sorted_vals = torch.sort(filled, dim=-1).values
    count = torch.sum(mask, dim=-1)
    lo_idx = torch.clamp((count - 1) // 2, min=0)
    hi_idx = torch.clamp(count // 2, min=0)
    lo = torch.take_along_dim(sorted_vals, lo_idx[..., None], dim=-1)[..., 0]
    hi = torch.take_along_dim(sorted_vals, hi_idx[..., None], dim=-1)[..., 0]
    med = 0.5 * (lo + hi)
    return torch.where(count > 0, med, torch.full_like(med, big))


def masked_argmin(values: Tensor, mask: Tensor) -> Tensor:
    """Argmin over the last axis restricted to masked slots (lowest index on
    ties)."""
    return torch.argmin(torch.where(mask, values, torch.full_like(values, math.inf)), dim=-1)


def first_true(mask: Tensor) -> Tensor:
    """Index of the first True along the last axis (0 when none), as
    `jnp.argmax` of a boolean array."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


def stable_compact(mask: Tensor, length: int | None = None) -> tuple[Tensor, Tensor]:
    """Indices that gather the True slots of ``mask`` (..., N) to the front,
    stably. Returns (gather_indices (..., length), valid (..., length));
    slots past N index 0."""
    n = mask.shape[-1]
    length = n if length is None else length
    iota = torch.arange(n, device=mask.device)
    key = torch.where(mask, iota, n + iota)
    order = torch.argsort(key, dim=-1, stable=True)
    if length <= n:
        order = order[..., :length]
    else:
        pad = torch.zeros(order.shape[:-1] + (length - n,), dtype=order.dtype, device=order.device)
        order = torch.cat([order, pad], dim=-1)
    count = torch.sum(mask, dim=-1)
    valid = torch.arange(length, device=mask.device) < count[..., None]
    return order, valid
