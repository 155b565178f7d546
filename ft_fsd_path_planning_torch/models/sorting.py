"""Cone sorting — fixed-width beam search over masked cone adjacency.

Counterpart of `ft_fsd_path_planning_tpu/models/sorting.py` (reference
`sorting_cones/trace_sorter/*`), default path: the exhaustive DFS of the
reference becomes a K-wide beam search of L-1 steps that scores all (K, C)
neighbour extensions with the reference's pruning gates as boolean masks,
ranks the children by an incrementally kept partial cost and keeps the best
K; the winner is chosen by the full 7-term cost (`sorting_cost.py`).

Both sides of every frame run as one batch of G = 2B searches (``cone_type``
is a (G,) tensor), as the JAX package vmaps over the side. The search itself
has two implementations that share their initial state: the fused kernel B2
(`ops/beam_search.py`, one launch for all G searches) and the plain PyTorch
port of the XLA scan (`_beam_scan`). :func:`_use_fused_beam` picks one.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from ft_fsd_path_planning_torch.config import PlannerConfig, SortingConfig
from ft_fsd_path_planning_torch.models import sorting_cost
from ft_fsd_path_planning_torch.models.sorting_cost import left_sign
from ft_fsd_path_planning_torch.ops import beam_search as bs
from ft_fsd_path_planning_torch.ops import gatherless as gl
from ft_fsd_path_planning_torch.ops import geometry as geo
from ft_fsd_path_planning_torch.utils import timer
from ft_fsd_path_planning_torch.utils.cone_types import ConeTypes

Tensor = torch.Tensor

_INF = math.inf


def _use_fused_beam(device: torch.device, cfg: SortingConfig) -> bool:
    """Whether the search runs as the fused kernel B2 (`ops/beam_search.py`)
    or as the scan, read from ``FT_FSD_FUSED_BEAM`` as in the JAX package and
    from the search's shape.

    On a CUDA device the kernel is the sorter's path unless the variable is
    ``0`` or the kernel does not take the shape (beam_width, max_length,
    max_n_neighbors) (`bs.kernel_supports`: beam width 8, 16, 32 or 64, max
    length up to 32, up to 7 neighbours): the scan is thousands of small
    launches per call, the kernel one. On the CPU the scan runs unless the
    variable is ``1``, which selects the kernel's plain PyTorch version (the
    tests use it). The choice is made from the shape alone, before anything is
    launched; a kernel that fails to build or launch raises, it never selects
    the scan."""
    flag = os.environ.get("FT_FSD_FUSED_BEAM", "")
    if device.type == "cuda":
        return flag != "0" and bs.kernel_supports(cfg.beam_width, cfg.max_length, cfg.max_n_neighbors)
    return flag == "1"


def _invert(cone_type: Tensor) -> Tensor:
    """LEFT (2) <-> RIGHT (1)."""
    return 3 - cone_type


def _inf_like(x: Tensor) -> Tensor:
    return torch.full_like(x, _INF)


def _norm(v: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


# ---------------------------------------------------------------------------
# start-cone selection (core_trace_sorter.py:344-465)
# ---------------------------------------------------------------------------


def select_starting_cones(
    cfg: SortingConfig,
    points: Tensor,
    mask: Tensor,
    cone_type: Tensor,
    car_position: Tensor,
    car_direction: Tensor,
) -> tuple[Tensor, Tensor]:
    """Up to two starting cones per search: the closest valid cone in front
    and the cone behind, ordered behind->front. Returns (prefix (G, 2) int,
    n_first (G,))."""
    xy = points[..., :2]
    color = points[..., 2]
    n = xy.shape[1]

    rel = geo.rotate(
        xy - car_position[:, None], -geo.angle_from_2d_vector(car_direction)[:, None]
    )
    rel_angle = geo.angle_from_2d_vector(rel)
    dist = _norm(rel)

    in_ellipse = geo.points_inside_ellipse(
        xy, car_position, car_direction,
        cfg.max_dist_to_first * 1.5, cfg.max_dist_to_first / 1.5,
    )
    sign_ok = torch.sign(rel_angle) == left_sign(cone_type)[:, None]
    angle_ok = (torch.abs(rel_angle) < math.pi - math.pi / 5) & (
        torch.abs(rel_angle) > math.pi / 10
    )
    right_color = color == cone_type[:, None]
    side_ok = (sign_ok & angle_ok) | right_color
    not_opposite = color != _invert(cone_type)[:, None]
    base = in_ellipse & side_ok & not_opposite & mask

    d1 = torch.where(base, dist, _inf_like(dist))
    i1 = torch.argmin(d1, dim=1)
    ok1 = torch.amin(d1, dim=1) <= cfg.max_dist_to_first

    # second cone: behind the car, not the first
    angle_to_car = geo.vec_angle_between(xy - car_position[:, None], car_direction[:, None])
    iota = torch.arange(n, device=xy.device)[None, :]
    skip = (torch.abs(angle_to_car) < math.pi / 2) | (iota == i1[:, None])
    d2 = torch.where(base & ~skip, dist, _inf_like(dist))
    i2 = torch.argmin(d2, dim=1)
    ok2 = torch.amin(d2, dim=1) <= cfg.max_dist_to_first

    xy12 = gl.take_rows(xy, torch.stack([i1, i2], dim=1))
    cone_dir_1 = xy12[:, 0] - xy12[:, 1]
    a1 = geo.vec_angle_between(cone_dir_1, car_direction)
    a2 = geo.vec_angle_between(-cone_dir_1, car_direction)
    swap = a1 > a2
    j1 = torch.where(swap, i2, i1)
    j2 = torch.where(swap, i1, i2)

    dd = _norm(cone_dir_1)
    pair_ok = ok2 & (dd <= cfg.max_dist * 1.1) & (dd >= 1.4)

    single = torch.where(ok2, j1, i1)  # post-swap index_1 when a pair was found
    prefix = torch.where(
        pair_ok[:, None],
        torch.stack([j2, j1], dim=1),
        torch.stack([single, torch.full_like(single, -1)], dim=1),
    )
    n_first = torch.where(~ok1, 0, torch.where(pair_ok, 2, 1))
    return prefix, n_first


# ---------------------------------------------------------------------------
# adjacency (adjacency_matrix.py:60-128) + reachability (common.py:37-67)
# ---------------------------------------------------------------------------


def build_adjacency(
    cfg: SortingConfig,
    points: Tensor,
    mask: Tensor,
    cone_type: Tensor,
    start_idx: Tensor,
) -> tuple[Tensor, Tensor, Tensor]:
    """Masked k-NN adjacency, symmetrized; returns (adj (G, N, N) bool,
    node_table (G, N, 4C), target_length (G,)).

    The node table packs, per cone, its <= C surviving neighbours as
    [idx | ok | x | y].
    """
    n = points.shape[1]
    c = cfg.max_n_neighbors
    xy = points[..., :2]
    color = points[..., 2]
    dev = xy.device

    d2 = geo.cdist_sq(xy, xy)
    opposite = color == _invert(cone_type)[:, None]
    bad = (
        opposite[:, :, None]
        | opposite[:, None, :]
        | ~mask[:, :, None]
        | ~mask[:, None, :]
        | torch.eye(n, dtype=torch.bool, device=dev)
    )
    d2 = torch.where(bad, _inf_like(d2), d2)

    # k-nearest by k argmin-extract rounds (lowest index first on ties, the
    # order of lax.top_k)
    iota_n = torch.arange(n, device=dev)
    cur = d2
    adj = torch.zeros_like(bad)
    for _ in range(c):
        pick = torch.argmin(cur, dim=-1)
        hit = iota_n == pick[..., None]
        adj = adj | hit
        cur = torch.where(hit, _inf_like(cur), cur)
    adj = adj & (d2 <= cfg.max_dist**2)
    adj = adj & adj.transpose(1, 2)

    # reachable set: max_length propagation rounds give min(reachable, L)
    reach = iota_n[None, :] == start_idx[:, None]
    for _ in range(cfg.max_length):
        reach = reach | torch.any(adj & reach[:, None, :], dim=-1)
    target_length = torch.clamp(torch.sum(reach, dim=1), max=cfg.max_length)

    # compressed neighbour lists: set bits in index order, then unset bits
    # (the stable order of lax.top_k(adj, k))
    order = torch.sort((~adj).to(torch.int8), dim=-1, stable=True).indices
    nb_idx = order[..., :c]
    n_set = torch.sum(adj, dim=-1)
    neighbor_ok = torch.arange(c, device=dev)[None, None, :] < n_set[..., None]
    nb_pos = gl.take_rows(xy, nb_idx.reshape(-1, n * c)).reshape(-1, n, c, 2)
    node_table = torch.cat(
        [
            nb_idx.to(torch.float32),
            neighbor_ok.to(torch.float32),
            nb_pos[..., 0],
            nb_pos[..., 1],
        ],
        dim=2,
    )
    return adj, node_table, target_length


# ---------------------------------------------------------------------------
# beam search (replaces end_configurations.py DFS)
# ---------------------------------------------------------------------------


def _angle_xy(ax, ay, bx, by):
    """geo.vec_angle_between on components (identical arithmetic)."""
    na = torch.sqrt(torch.clamp(ax * ax + ay * ay, min=0.0))
    nb = torch.sqrt(torch.clamp(bx * bx + by * by, min=0.0))
    cos_t = (ax * bx + ay * by) / torch.clamp(na * nb, min=1e-12)
    return torch.arccos(torch.clamp(cos_t, -1.0, 1.0))


def _gate_items(cfg: SortingConfig) -> tuple:
    """The gate constants of the fused search, by name."""
    return (
        ("ellipse_major", cfg.ellipse_major),
        ("ellipse_minor", cfg.ellipse_minor),
        ("side_eps", math.radians(5.0)),
        ("between_angle", cfg.between_angle),
        ("between_dist", cfg.between_dist),
        ("thr_abs", cfg.threshold_absolute_angle),
        ("thr_dir", cfg.threshold_directional_angle),
        ("close_dist", cfg.close_cone_dist),
        ("car_size", cfg.car_size),
        ("under_angle", math.radians(40.0)),
    )


def _initial_beam_state(
    cfg: SortingConfig,
    beam_width: int,
    points: Tensor,
    prefix: Tensor,
    n_first: Tensor,
    car_direction: Tensor,
) -> tuple[Tensor, Tensor]:
    """The packed search state before the first step: (feats (G, F, K),
    alive (G, K) bool), slot 0 holding the start prefix.

    F = L + 16 rows: configs (L), length, done, angle_sum, n_under,
    residual, init_cost, wrong_sum, last_idx, last xy, prev xy, prev2 xy,
    first xy (the layout of `ops/beam_search.py`)."""
    g = points.shape[0]
    k = beam_width
    l = cfg.max_length
    dev = points.device
    xy = points[..., :2]
    two = n_first >= 2
    p0 = gl.take_rows(xy, prefix)  # (G, 2, 2); a -1 prefix reads a zero row
    init_cost0 = torch.where(two, geo.vec_angle_between(p0[:, 1] - p0[:, 0], car_direction), 0.0)
    last_idx0 = torch.where(two, prefix[:, 1], prefix[:, 0])
    last0 = torch.where(two[:, None], p0[:, 1], p0[:, 0])
    feats = torch.zeros((g, l + 16, k), dtype=torch.float32, device=dev)
    feats[:, :l] = -1.0
    feats[:, 0, 0] = prefix[:, 0].float()
    feats[:, 1, 0] = torch.where(two, prefix[:, 1], -1).float()
    feats[:, l, 0] = n_first.float()
    feats[:, l + 5, 0] = init_cost0
    feats[:, l + 7] = -1.0
    feats[:, l + 7, 0] = last_idx0.float()
    feats[:, l + 8 : l + 10, 0] = last0
    for row in (l + 10, l + 12, l + 14):  # prev, prev2 and first start at p0[0]
        feats[:, row : row + 2, 0] = p0[:, 0]
    alive = (torch.arange(k, device=dev)[None, :] == 0) & (n_first >= 1)[:, None]
    return feats, alive


def _beam_search_side(
    cfg: SortingConfig,
    points: Tensor,
    mask: Tensor,
    cone_type: Tensor,
    prefix: Tensor,
    n_first: Tensor,
    car_position: Tensor,
    car_direction: Tensor,
    node_table: Tensor,
    target_length: Tensor,
) -> tuple[Tensor, Tensor]:
    """Run the beam searches; returns (configs (G, K, L), pool_valid (G, K))."""
    l = cfg.max_length
    feats, alive = _initial_beam_state(cfg, cfg.beam_width, points, prefix, n_first, car_direction)
    if _use_fused_beam(points.device, cfg):
        # the whole search loop as one call of kernel B2
        params = torch.stack(
            [
                car_position[:, 0], car_position[:, 1],
                car_direction[:, 0], car_direction[:, 1],
                left_sign(cone_type), target_length.to(torch.float32),
            ],
            dim=1,
        )
        feats, alive_f = bs.fused_beam_search(
            node_table.contiguous(), feats, alive.to(torch.float32), params,
            k=cfg.beam_width, l=l, c=cfg.max_n_neighbors,
            weights=tuple(float(sorting_cost.WEIGHTS[i]) for i in (0, 1, 2, 3, 6)),
            gates=dict(_gate_items(cfg)),
        )
        timer.count("sorting.b2.launches")  # B2's plain version on the CPU; the scan counts none
        alive = alive_f > 0.5
    else:
        feats, alive = _beam_scan(
            cfg, feats, alive, cone_type, car_position, car_direction, node_table, target_length
        )
    out_configs = torch.round(feats[:, :l]).to(torch.int64).transpose(1, 2)
    return out_configs, alive


def _beam_scan(
    cfg: SortingConfig,
    feats: Tensor,
    alive: Tensor,
    cone_type: Tensor,
    car_position: Tensor,
    car_direction: Tensor,
    node_table: Tensor,
    target_length: Tensor,
) -> tuple[Tensor, Tensor]:
    """The search as a loop of L - 1 steps of plain PyTorch, from the packed
    initial state; returns the final (feats (G, F, K), alive (G, K)).

    Candidates are flat j-major (G, C*K) arrays, which is the pool's child
    order, so ties break as in the JAX package.
    """
    g, _, k = feats.shape
    l = cfg.max_length
    c = cfg.max_n_neighbors
    ck = c * k
    dev = feats.device
    w = [float(v) for v in sorting_cost.WEIGHTS]
    sgn = left_sign(cone_type)[:, None]
    under_angle = geo.deg2rad(40.0)
    cos_between = float(np.cos(np.float32(cfg.between_angle)))
    side_eps = geo.deg2rad(5.0)

    dnorm = car_direction / _norm(car_direction)[:, None]
    car_s = car_position - dnorm * cfg.car_size / 2
    car_e = car_position + dnorm * cfg.car_size
    col = lambda v: v[:, None]  # noqa: E731  (G,) -> (G, 1)
    car_sx, car_sy, car_ex, car_ey = col(car_s[:, 0]), col(car_s[:, 1]), col(car_e[:, 0]), col(car_e[:, 1])
    cp_x, cp_y = col(car_position[:, 0]), col(car_position[:, 1])
    cd_x, cd_y = col(car_direction[:, 0]), col(car_direction[:, 1])

    def T(a: Tensor) -> Tensor:  # parent column (G, K) -> (G, C*K) j-major
        return a.repeat(1, c)

    def partial_score(length, angle_sum, n_under, residual, init_cost, wrong_sum):
        n_int = torch.clamp(length - 2.0, min=1.0)
        return (
            w[0] * angle_sum / n_int * (n_under + 1.0)
            + w[1] * residual
            + w[2] / torch.clamp(length, min=1.0)
            + w[3] * init_cost
            + w[6] * torch.abs(wrong_sum) * (length >= 4.0)
        )

    iota_k = torch.arange(k, device=dev)[None, :]
    for _ in range(l - 1):
        configs = [feats[:, j] for j in range(l)]
        lengths = feats[:, l]
        done = feats[:, l + 1] > 0.5
        angle_sum, n_under = feats[:, l + 2], feats[:, l + 3]
        residual, init_cost = feats[:, l + 4], feats[:, l + 5]
        wrong_sum, last_idx = feats[:, l + 6], feats[:, l + 7]
        last_x, last_y = feats[:, l + 8], feats[:, l + 9]
        prev_x, prev_y = feats[:, l + 10], feats[:, l + 11]
        prev2_x, prev2_y = feats[:, l + 12], feats[:, l + 13]
        first_x, first_y = feats[:, l + 14], feats[:, l + 15]
        p = lengths - 1.0

        # expansion: the node-table row of each beam's tail cone
        row = gl.take_rows(node_table, torch.round(last_idx).to(torch.int64))  # (G, K, 4C)

        def flat_block(off):  # (G, K, C) slice -> (G, C*K) j-major
            return row[:, :, off * c : (off + 1) * c].transpose(1, 2).reshape(g, ck)

        cand_f = flat_block(0)
        can0_f = flat_block(1) > 0.5
        cx_f = flat_block(2)
        cy_f = flat_block(3)

        # shared tail geometry (per parent, tiled once)
        mjx, mjy = last_x - prev_x, last_y - prev_y
        inv = torch.rsqrt(torch.clamp(mjx * mjx + mjy * mjy, min=1e-24))
        umx, umy = mjx * inv, mjy * inv  # ellipse major direction
        ppx, ppy = prev_x - prev2_x, prev_y - prev2_y
        diff2 = torch.atan2(ppx * mjy - ppy * mjx, ppx * mjx + ppy * mjy)

        expandable = alive & ~done & (lengths < target_length[:, None])

        lx, ly = T(last_x), T(last_y)
        p_f = T(p)
        umx_f, umy_f = T(umx), T(umy)
        fx, fy = T(first_x), T(first_y)
        relx, rely = cx_f - lx, cy_f - ly

        # 1. not already in config
        in_cfg = T(configs[0]) == cand_f
        for jj in range(1, l):
            in_cfg = in_cfg | (T(configs[jj]) == cand_f)
        ok = can0_f & ~in_cfg
        # 2. ellipse gate (p >= 1)
        xr = relx * umx_f + rely * umy_f
        yr = umx_f * rely - umy_f * relx
        ell = (xr / cfg.ellipse_major) ** 2 + (yr / cfg.ellipse_minor) ** 2 < 1.0
        ok = ok & (ell | (p_f < 1.0))
        # 3. second cone on the correct side (p == 0)
        ccx, ccy = cx_f - cp_x, cy_f - cp_y
        dsign = torch.atan2(cd_x * ccy - cd_y * ccx, cd_x * ccx + cd_y * ccy)
        side_ok = (torch.sign(dsign) == sgn) | (torch.abs(dsign) < side_eps)
        ok = ok & (side_ok | (p_f != 0.0))
        # 4. no cone skipped between last and candidate
        blocked = torch.zeros_like(ok)
        for m in range(c):
            cxm = T(row[:, :, 2 * c + m])
            cym = T(row[:, :, 3 * c + m])
            can0m = T(row[:, :, c + m] > 0.5)
            candm = T(row[:, :, m])
            d_ml_m = torch.sqrt((lx - cxm) ** 2 + (ly - cym) ** 2)
            vmcx, vmcy = cx_f - cxm, cy_f - cym
            d_mc = torch.sqrt(vmcx * vmcx + vmcy * vmcy)
            dots = (lx - cxm) * vmcx + (ly - cym) * vmcy
            blocked = blocked | (
                can0m
                & (cand_f != candm)
                & (d_mc < cfg.between_dist)
                & (d_ml_m < cfg.between_dist)
                & (dots < cos_between * d_ml_m * d_mc)
            )
        ok = ok & ~blocked
        # 5. direction-change thresholds (p >= 1)
        mjx_f, mjy_f = T(mjx), T(mjy)
        dj = torch.atan2(mjx_f * rely - mjy_f * relx, mjx_f * relx + mjy_f * rely)
        sl = torch.sqrt(relx * relx + rely * rely)
        abs_ok = torch.abs(dj) <= cfg.threshold_absolute_angle
        directional = (sgn * dj < cfg.threshold_directional_angle) | (sl < cfg.close_cone_dist)
        ok = ok & ((abs_ok & directional) | (p_f < 1.0))
        # 6. flip-kill (p >= 2)
        diff2_f = T(diff2)
        flip = (torch.sign(dj) != torch.sign(diff2_f)) & (torch.abs(dj - diff2_f) > 1.3)
        ok = ok & (~flip | (p_f < 2.0))
        # 7. offset from start (p == 1)
        off_ok = cd_x * (cx_f - fx) + cd_y * (cy_f - fy) > 0.0
        ok = ok & (off_ok | (p_f != 1.0))
        # 8. no car-body crossing (geo.segments_intersect on components)
        eps = 1e-6
        bdx, bdy = car_ex - car_sx, car_ey - car_sy
        d1 = bdx * (ly - car_sy) - bdy * (lx - car_sx)
        d2 = bdx * (cy_f - car_sy) - bdy * (cx_f - car_sx)
        d3 = relx * (car_sy - ly) - rely * (car_sx - lx)
        d4 = relx * (car_ey - ly) - rely * (car_ex - lx)
        proper = ((d1 > eps) & (d2 < -eps) | (d1 < -eps) & (d2 > eps)) & (
            (d3 > eps) & (d4 < -eps) | (d3 < -eps) & (d4 > eps)
        )

        def on_seg(px0, py0, qx, qy, rx, ry):
            wx = (rx >= torch.minimum(px0, qx) - eps) & (rx <= torch.maximum(px0, qx) + eps)
            wy = (ry >= torch.minimum(py0, qy) - eps) & (ry <= torch.maximum(py0, qy) + eps)
            return wx & wy

        collinear_touch = (
            (torch.abs(d1) <= eps) & on_seg(car_sx, car_sy, car_ex, car_ey, lx, ly)
            | (torch.abs(d2) <= eps) & on_seg(car_sx, car_sy, car_ex, car_ey, cx_f, cy_f)
            | (torch.abs(d3) <= eps) & on_seg(lx, ly, cx_f, cy_f, car_sx, car_sy)
            | (torch.abs(d4) <= eps) & on_seg(lx, ly, cx_f, cy_f, car_ex, car_ey)
        )
        ok = ok & ~(proper | collinear_touch) & T(expandable)

        theta_f = _angle_xy(T(prev_x) - lx, T(prev_y) - ly, relx, rely)

        # children carries + scores, flat
        add_int_f = T(p >= 1.0)
        c_len_f = T(lengths + 1.0)
        zero = torch.zeros_like(theta_f)
        a_sum_f = T(angle_sum) + torch.where(add_int_f, (math.pi - theta_f) / math.pi, zero)
        nu_f = T(n_under) + torch.where(add_int_f & (theta_f < under_angle), 1.0, 0.0)
        res_f = T(residual) + torch.clamp(sl - 3.0, min=0.0)
        f_ang = _angle_xy(cx_f - fx, cy_f - fy, cd_x, cd_y)
        ini_f = torch.where(p_f == 0.0, f_ang, T(init_cost))
        wr_f = T(wrong_sum) + torch.where(
            add_int_f & (torch.sign(dj) == sgn) & (torch.abs(dj) > under_angle), dj, zero
        )
        sc = partial_score(c_len_f, a_sum_f, nu_f, res_f, ini_f, wr_f)
        scores_children_f = torch.where(ok, sc, _inf_like(sc))

        # parents that could not expand become leaves
        any_can = torch.any(ok.reshape(g, c, k), dim=1)
        done2 = done | (expandable & ~any_can)
        frozen = alive & (done2 | ~expandable)
        parent_score = torch.where(
            frozen,
            partial_score(lengths, angle_sum, n_under, residual, init_cost, wrong_sum),
            _inf_like(lengths),
        )

        # pool: K frozen parents + the j-major flat children -> (G, F, P)
        child_rows = [
            torch.where(T(lengths) == float(jj), cand_f, T(configs[jj])) for jj in range(l)
        ]
        child_rows += [
            c_len_f, torch.zeros_like(c_len_f), a_sum_f, nu_f, res_f, ini_f, wr_f,
            cand_f, cx_f, cy_f, lx, ly, T(prev_x), T(prev_y), fx, fy,
        ]
        parent_feats = feats.clone()
        parent_feats[:, l + 1] = done2.to(feats.dtype)
        pool_feats = torch.cat([parent_feats, torch.stack(child_rows, dim=1)], dim=2)
        pool_scores = torch.cat([parent_score, scores_children_f], dim=1)

        # exact top-K by (score, pool index): a stable ascending sort
        sel = torch.sort(pool_scores, dim=1, stable=True).indices[:, :k]
        feats = torch.take_along_dim(pool_feats, sel[:, None, :], dim=2)
        sel_valid = iota_k < torch.sum(torch.isfinite(pool_scores), dim=1, keepdim=True)

        # invalid slots: configs -1, length 0, done 0, last_idx -1
        invalid = ~sel_valid[:, None, :]
        feats[:, :l] = torch.where(invalid, -1.0, feats[:, :l])
        feats[:, l : l + 2] = torch.where(invalid, 0.0, feats[:, l : l + 2])
        feats[:, l + 7 : l + 8] = torch.where(invalid, -1.0, feats[:, l + 7 : l + 8])
        alive = sel_valid

    return feats, alive


def _postfilter_pool(
    points: Tensor, configs: Tensor, valid: Tensor, cone_type: Tensor
) -> tuple[Tensor, Tensor]:
    """End-configuration post-processing (end_configurations.py:484-518):
    >= 3 cones, strip a trailing wrong-color cone, drop duplicates and strict
    prefixes of other pool configs."""
    _, k, l = configs.shape
    dev = configs.device
    iota_l = torch.arange(l, device=dev)
    lengths = torch.sum(configs != -1, dim=2)
    valid = valid & (lengths >= 3)

    last_pos = torch.clamp(lengths - 1, min=0)
    at_last = iota_l == last_pos[..., None]
    last_cone = torch.sum(torch.where(at_last, configs, 0), dim=2)
    last_color = gl.take_vec(points[..., 2], torch.clamp(last_cone, 0, points.shape[1] - 1))
    strip = (last_color != cone_type[:, None]) & valid
    configs = torch.where(strip[..., None] & at_last, -1, configs)
    lengths = lengths - strip.to(lengths.dtype)
    valid = valid & (lengths >= 3)
    configs = torch.where(valid[..., None], configs, -1)

    # exact duplicates: keep the first occurrence
    pair_valid = valid[:, :, None] & valid[:, None, :]
    same = torch.all(configs[:, :, None, :] == configs[:, None, :, :], dim=-1) & pair_valid
    iota_k = torch.arange(k, device=dev)
    earlier = iota_k[:, None] < iota_k[None, :]
    valid = valid & ~torch.any(same & earlier, dim=1)

    # strict-prefix removal: config j goes when some other config i matches
    # j on all of j's non(-1) positions
    eq = (configs[:, :, None, :] == configs[:, None, :, :]) | (configs[:, None, :, :] == -1)
    prefix = torch.all(eq, dim=-1) & valid[:, :, None] & valid[:, None, :]
    not_self = ~torch.eye(k, dtype=torch.bool, device=dev)
    valid = valid & ~torch.any(prefix & not_self, dim=1)
    return torch.where(valid[..., None], configs, -1), valid


class SideResult(NamedTuple):
    configs: Tensor  # (G, K, L) pool
    valid: Tensor  # (G, K)
    costs: Tensor  # (G, K)
    best: Tensor  # (G, L) best config (-1 padded)
    has_result: Tensor  # (G,)


def sort_one_side(
    cfg: PlannerConfig,
    points: Tensor,
    mask: Tensor,
    cone_type: Tensor,
    car_position: Tensor,
    car_direction: Tensor,
) -> SideResult:
    """Reference calc_configurations_with_score_for_one_side plus
    calc_scores_and_end_configurations, for G searches at once."""
    s = cfg.sorting
    prefix, n_first = select_starting_cones(s, points, mask, cone_type, car_position, car_direction)
    startable = (n_first >= 1) & (torch.sum(mask, dim=1) >= 3)

    _, node_table, target_length = build_adjacency(s, points, mask, cone_type, prefix[:, 0])
    configs, valid = _beam_search_side(
        s, points, mask, cone_type, prefix, n_first,
        car_position, car_direction, node_table, target_length,
    )
    configs, valid = _postfilter_pool(points, configs, valid, cone_type)
    valid = valid & startable[:, None]

    costs = sorting_cost.cost_configurations(
        points, mask, configs, valid, cone_type, car_position, car_direction, s
    )
    best_idx = torch.argmin(costs, dim=1)
    has_result = torch.any(valid, dim=1) & startable
    best_row = torch.take_along_dim(configs, best_idx[:, None, None], dim=1)[:, 0]
    best = torch.where(has_result[:, None], best_row, -1)
    return SideResult(configs=configs, valid=valid, costs=costs, best=best, has_result=has_result)


# ---------------------------------------------------------------------------
# left/right combination (combine_traces.py:21-275)
# ---------------------------------------------------------------------------


def _angle_change_at(points_xy: Tensor, config: Tensor, pos: Tensor) -> Tensor:
    """calc_angle_change_at_position (combine_traces.py:260-275)."""
    l = config.shape[1]
    idx3 = torch.clamp(torch.stack([pos - 1, pos, pos + 1], dim=1), 0, l - 1)
    cfg3 = torch.take_along_dim(config, idx3, dim=1)
    pts3 = gl.take_rows(points_xy, cfg3)  # padded (-1) slots -> zero rows
    prev_c, inter, next_c = pts3[:, 0], pts3[:, 1], pts3[:, 2]
    a_next = geo.angle_from_2d_vector(next_c - inter)
    a_prev = geo.angle_from_2d_vector(prev_c - inter)
    return geo.angle_difference(a_next, a_prev)


def combine_traces(
    points: Tensor,
    left: SideResult,
    right: SideResult,
    car_position: Tensor,
    car_direction: Tensor,
) -> tuple[Tensor, Tensor]:
    """Pick the best config per side and resolve cones claimed by both
    (calc_final_configs_for_left_and_right). Returns (left (B, L), right
    (B, L)) -1-padded index configs."""
    xy = points[..., :2]
    n = xy.shape[1]
    l = left.best.shape[1]
    dev = xy.device
    iota = torch.arange(l, device=dev)[None, :]

    left_cfg = torch.where(left.has_result[:, None], left.best, -1)
    right_cfg = torch.where(right.has_result[:, None], right.best, -1)
    len_l = torch.sum(left_cfg != -1, dim=1)
    len_r = torch.sum(right_cfg != -1, dim=1)

    # first common cone positions
    common = (
        (left_cfg[:, :, None] == right_cfg[:, None, :])
        & (left_cfg[:, :, None] != -1)
        & (right_cfg[:, None, :] != -1)
    )
    has_common = torch.any(common, dim=(1, 2))
    big = l + 1
    li = torch.amin(torch.where(torch.any(common, dim=2), iota, big), dim=1)
    ri = torch.amin(torch.where(torch.any(common, dim=1), iota, big), dim=1)

    # --- the arbitration decision table (combine_traces.py:150-257)
    both_cfg = torch.cat([left_cfg, right_cfg], dim=1)  # (B, 2L)
    idx = torch.cat(
        [
            torch.clamp(torch.stack([li, li - 1, li], dim=1), 0, l - 1),
            l + torch.clamp(torch.stack([ri - 1, ri], dim=1), 0, l - 1),
        ],
        dim=1,
    )  # [inter@li, prev_left, left@li, prev_right, right@ri]
    cones5 = torch.take_along_dim(both_cfg, idx, dim=1)
    pts3 = gl.take_rows(xy, torch.clamp(cones5[:, :4], 0, n - 1))
    d_left = _norm(pts3[:, 0] - pts3[:, 1])
    d_right = _norm(pts3[:, 0] - pts3[:, 3])

    both_pos = (li > 0) & (ri > 0)
    ll = d_left < 3.0
    rl = d_right < 3.0
    rule1 = both_pos & (ll ^ rl)
    r1_left_stop = torch.where(ll, len_l, li)
    r1_right_stop = torch.where(ll, ri, len_r)

    # middle-intersection rule
    same_cone = cones5[:, 2] == cones5[:, 4]
    li_mid = (li >= 1) & (li <= len_l - 2)
    ri_mid = (ri >= 1) & (ri <= len_r - 2)
    rule2 = ~rule1 & same_cone & li_mid & ri_mid

    angle_left = _angle_change_at(xy, left_cfg, li)
    angle_right = _angle_change_at(xy, right_cfg, ri)
    sign_same = torch.sign(angle_left) == torch.sign(angle_right)
    n_cones_diff = torch.abs(len_l - len_r)
    abs_angle_diff = torch.abs(torch.abs(angle_left) - torch.abs(angle_right))

    prefer_left = torch.where(
        sign_same,
        torch.sign(angle_left) == 1,
        torch.where(
            n_cones_diff > 2,
            len_l > len_r,
            torch.abs(angle_left) > torch.abs(angle_right),
        ),
    )
    r2_truncate_both = ~sign_same & ~(n_cones_diff > 2) & ~(abs_angle_diff > geo.deg2rad(5.0))
    r2_left_stop = torch.where(r2_truncate_both, li, torch.where(prefer_left, len_l, li))
    r2_right_stop = torch.where(r2_truncate_both, ri, torch.where(prefer_left, ri, len_r))

    # end-intersection rule
    l_end = li == len_l - 1
    r_end = ri == len_r - 1
    r3_left_stop = torch.where(
        l_end & r_end, len_l - 1, torch.where(l_end, li, torch.where(r_end, len_l, li))
    )
    r3_right_stop = torch.where(
        l_end & r_end, len_r - 1, torch.where(l_end, len_r, ri)
    )

    left_stop = torch.where(rule1, r1_left_stop, torch.where(rule2, r2_left_stop, r3_left_stop))
    right_stop = torch.where(rule1, r1_right_stop, torch.where(rule2, r2_right_stop, r3_right_stop))
    left_stop = torch.where(has_common, left_stop, len_l)
    right_stop = torch.where(has_common, right_stop, len_r)

    left_out = torch.where(iota < left_stop[:, None], left_cfg, -1)
    right_out = torch.where(iota < right_stop[:, None], right_cfg, -1)

    # one-sided / zero-sided cases (combine_traces.py:44-52, 68-90)
    lh, rh = left.has_result[:, None], right.has_result[:, None]
    left_out = torch.where(lh, left_out, -1)
    right_out = torch.where(rh, right_out, -1)
    left_out = torch.where(lh & ~rh, left_cfg, left_out)
    right_out = torch.where(rh & ~lh, right_cfg, right_out)
    return left_out, right_out


class SortingOutput(NamedTuple):
    left_cones: Tensor  # (B, L, 2)
    left_mask: Tensor  # (B, L)
    right_cones: Tensor  # (B, L, 2)
    right_mask: Tensor  # (B, L)


@timer.spanned("stage.sorting.run")
def run_cone_sorting(
    cfg: PlannerConfig,
    points: Tensor,
    mask: Tensor,
    car_position: Tensor,
    car_direction: Tensor,
) -> SortingOutput:
    """Reference TraceSorter.sort_left_right (core_trace_sorter.py:148-216).

    ``points`` is the flattened (B, N, 3) [x, y, color] cone tensor. Both
    sides of all B frames run as one batch of 2B searches: rows [0, B) are
    LEFT, rows [B, 2B) RIGHT.
    """
    bsz = points.shape[0]
    dev = points.device
    cone_type = torch.cat(
        [
            torch.full((bsz,), int(ConeTypes.LEFT), device=dev),
            torch.full((bsz,), int(ConeTypes.RIGHT), device=dev),
        ]
    )
    two = lambda t: torch.cat([t, t], dim=0)  # noqa: E731
    both = sort_one_side(cfg, two(points), two(mask), cone_type, two(car_position), two(car_direction))
    left = SideResult(*(t[:bsz] for t in both))
    right = SideResult(*(t[bsz:] for t in both))

    left_cfg, right_cfg = combine_traces(points, left, right, car_position, car_direction)
    xy = points[..., :2]

    def compact(config: Tensor) -> tuple[Tensor, Tensor]:
        order, valid = geo.stable_compact(config != -1)
        cones = gl.take_rows(xy, torch.take_along_dim(config, order, dim=1))
        return torch.where(valid[..., None], cones, torch.zeros_like(cones)), valid

    lc, lm = compact(left_cfg)
    rc, rm = compact(right_cfg)
    return SortingOutput(left_cones=lc, left_mask=lm, right_cones=rc, right_mask=rm)
