"""Cone sorting — fixed-width beam search over masked cone adjacency.

Counterpart of `ft_fsd_path_planning_tpu/models/sorting.py` (reference
`sorting_cones/trace_sorter/*`), default path: the exhaustive DFS of the
reference becomes a K-wide beam search of L-1 steps that scores all (K, C)
neighbour extensions with the reference's pruning gates as boolean masks,
ranks the children by an incrementally kept partial cost and keeps the best
K; the winner is chosen by the full 7-term cost (`sorting_cost.py`).

Both sides of every frame run as one batch of G = 2B searches (``cone_type``
is a (G,) tensor), as the JAX package vmaps over the side. The search itself
is one call of `ops/beam_search.py::fused_beam_search`, which runs it as the
fused kernel B2 off the CPU (one launch for all G searches) and as B2's plain
PyTorch version on the CPU.
"""

from __future__ import annotations

import math
from typing import NamedTuple

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
    params = torch.stack(
        [
            car_position[:, 0], car_position[:, 1],
            car_direction[:, 0], car_direction[:, 1],
            left_sign(cone_type), target_length.to(torch.float32),
        ],
        dim=1,
    )
    # the whole search loop as one call: kernel B2 or its plain version
    feats, alive_f = bs.fused_beam_search(
        node_table.contiguous(), feats, alive.to(torch.float32), params,
        k=cfg.beam_width, l=l, c=cfg.max_n_neighbors,
        weights=tuple(float(sorting_cost.WEIGHTS[i]) for i in (0, 1, 2, 3, 6)),
        gates=dict(_gate_items(cfg)),
    )
    timer.count("sorting.b2.launches")  # one a call: a launch of B2, on the CPU its plain version
    alive = alive_f > 0.5
    out_configs = torch.round(feats[:, :l]).to(torch.int64).transpose(1, 2)
    return out_configs, alive


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
