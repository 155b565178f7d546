"""Fused beam search of the cone sorter — kernel B2 of the port.

Counterpart of `ft_fsd_path_planning_tpu/ops/pallas/beam_search.py`. The TPU
kernel becomes the CUDA kernel `csrc/beam_search.cu`; this module holds its
wrapper, its plain PyTorch version (the kernel's arithmetic, step by step,
batched over the G independent searches) and the cost counters of its bound.

One call runs the whole ``L - 1``-step search for G (frame x side) searches:
expand the K beam fronts over the C neighbours of each tail cone, apply the
eight pruning gates, update the partial cost, keep the best K of the
``P = K + K*C`` pool by (score, pool index) and repack the survivors.

Feature-row layout of the state (packed by `models/sorting.py`), F = L + 16
rows of K columns:

  [configs(L) | length | done | angle_sum | n_under | residual | init_cost |
   wrong_sum | last_idx | last_pos(2) | prev_pos(2) | prev2_pos(2) |
   first_pos(2)]

Pool order: entries ``0..K-1`` are the frozen parents, entry
``K + j*K + k`` is the child of beam ``k`` over neighbour ``j``.

:func:`fused_beam_search` takes the plain version only for tensors on the
CPU. Off the CPU it launches the kernel or raises: a search shape the kernel
does not take raises :class:`UnsupportedShape`, which a planner for the card
raises already when it is made (:func:`require_kernel_shape`).
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter

import torch

from ft_fsd_path_planning_torch.ops import gatherless as gl
from ft_fsd_path_planning_torch.ops import kernel_build

Tensor = torch.Tensor

BIG = 1e30  # finite stand-in for +inf scores (inf would give NaN in arithmetic)

# params row layout
P_CARX, P_CARY, P_DIRX, P_DIRY, P_SIGN, P_TLEN = range(6)
N_PARAMS = 6

#: beam widths K the kernel is instantiated for (a template parameter:
#: 8 K threads a search)
KERNEL_BEAM_WIDTHS = (8, 16, 32, 64)
#: bounds of the run-time max length L and neighbour count C (C children and
#: the parent of a beam share one group of eight lanes)
KERNEL_MAX_LENGTH = 32
KERNEL_MAX_NEIGHBORS = 7


class UnsupportedShape(ValueError):
    """A shape a kernel does not take (B2's search shape (K, L, C), the
    matching kernel's side length, the parameterization kernel's window and
    horizon), asked of a device other than the CPU, where the work runs only
    as the kernel."""


def kernel_supports(k: int, l: int, c: int) -> bool:
    """Whether the CUDA kernel takes the search shape (K, L, C) = (beam
    width, max length, max neighbours): K in {8, 16, 32, 64}, 1 <= L <= 32,
    1 <= C <= 7."""
    return k in KERNEL_BEAM_WIDTHS and 1 <= l <= KERNEL_MAX_LENGTH and 1 <= c <= KERNEL_MAX_NEIGHBORS


def require_kernel_shape(k: int, l: int, c: int) -> None:
    """Raise :class:`UnsupportedShape` unless the kernel takes (K, L, C)."""
    if not kernel_supports(k, l, c):
        raise UnsupportedShape(
            f"the kernel does not take (K, L, C) = {(k, l, c)}: K in {KERNEL_BEAM_WIDTHS}, "
            f"L <= {KERNEL_MAX_LENGTH}, C <= {KERNEL_MAX_NEIGHBORS}"
        )


def instantiation(k: int, l: int, c: int) -> str:
    """Name of the kernel instantiation a supported shape launches, as
    ``fused_beam_search_f32`` dispatches: the sorter's default (32, 12, 5)
    has its own exact one, every other shape the general one of its beam
    width."""
    return "K=32 L=12 C=5" if (k, l, c) == (32, 12, 5) else f"K={k} L<={KERNEL_MAX_LENGTH} C<={KERNEL_MAX_NEIGHBORS}"


#: gate constants the search reads, by the names of `models/sorting.py::_gate_items`
GATE_NAMES = (
    "ellipse_major", "ellipse_minor", "side_eps", "between_angle", "between_dist",
    "thr_abs", "thr_dir", "close_dist", "car_size", "under_angle",
)

# Cephes atanf: polynomial on |u| <= tan(pi/8), reduction above it
_TAN_PI_8 = 0.4142135623730950
_ATAN_COEF = (8.05374449538e-2, 1.38776856032e-1, 1.99777106478e-1, 3.33329491539e-1)

#: launches of the CUDA kernel since the last reset (plain calls do not
#: count), in all and by instantiation (:func:`instantiation`)
launch_count = 0
launch_count_by_instantiation: Counter = Counter()


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0
    launch_count_by_instantiation.clear()


def feature_rows(l: int) -> int:
    return l + 16


def pool_size(k: int, c: int) -> int:
    return k + k * c


def search_constants(weights: tuple, gates: dict) -> tuple[float, ...]:
    """The sixteen configuration constants of a search, in the order of the
    kernel's ``Consts`` struct: five weights, then the gate constants with
    the two derived ones (cosine of the between-angle, half the car size)
    computed here in double precision, once, for kernel and plain alike."""
    w0, w1, w2, w3, w6 = (float(w) for w in weights)
    return (
        w0, w1, w2, w3, w6,
        float(gates["ellipse_major"]), float(gates["ellipse_minor"]),
        float(gates["side_eps"]), math.cos(gates["between_angle"]),
        float(gates["between_dist"]), float(gates["thr_abs"]), float(gates["thr_dir"]),
        float(gates["close_dist"]), gates["car_size"] / 2.0, float(gates["car_size"]),
        float(gates["under_angle"]),
    )


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _div(a, b) -> Tensor:
    """True float32 division with both operands as tensors. PyTorch turns a
    division by a Python scalar into a multiplication by its reciprocal on
    CUDA, and ``scalar / tensor`` into ``reciprocal * scalar`` everywhere;
    the kernel divides."""
    ref = a if isinstance(a, Tensor) else b
    if not isinstance(a, Tensor):
        a = torch.full_like(ref, a)
    if not isinstance(b, Tensor):
        b = torch.full_like(ref, b)
    return torch.div(a, b)


def atan2_plain(y: Tensor, x: Tensor) -> Tensor:
    """Cephes-style float32 atan2 from elementwise primitives (~1e-6 rad),
    the arithmetic of the kernel's ``atan2_cephes``."""
    a3, a2, a1, a0 = _ATAN_COEF
    ax, ay = torch.abs(x), torch.abs(y)
    big = torch.maximum(ax, ay)
    small = torch.minimum(ax, ay)
    t = _div(small, torch.clamp(big, min=1e-30))  # in [0, 1]
    use_red = t > _TAN_PI_8
    u = torch.where(use_red, _div(t - 1.0, t + 1.0), t)
    z = u * u
    p = (((a3 * z - a2) * z + a1) * z - a0) * z * u + u
    a = torch.where(use_red, 0.25 * math.pi + p, p)
    a = torch.where(ay > ax, 0.5 * math.pi - a, a)  # undo the min/max swap
    a = torch.where(x < 0.0, math.pi - a, a)
    a = torch.where(y < 0.0, -a, a)
    return torch.where((ax == 0.0) & (ay == 0.0), torch.zeros_like(a), a)


def _angle_between(vx, vy, wx, wy) -> Tensor:
    """Angle in [0, pi] between 2-D vectors: atan2(|cross|, dot)."""
    cross = vx * wy - vy * wx
    dot = vx * wx + vy * wy
    return atan2_plain(torch.abs(cross), dot)


def _seg_intersect(ax0, ay0, ax1, ay1, bx0, by0, bx1, by1, eps=1e-6) -> Tensor:
    """`geometry.segments_intersect` on coordinate components."""

    def orient(px, py, qx, qy, rx, ry):
        return (qx - px) * (ry - py) - (qy - py) * (rx - px)

    d1 = orient(bx0, by0, bx1, by1, ax0, ay0)
    d2 = orient(bx0, by0, bx1, by1, ax1, ay1)
    d3 = orient(ax0, ay0, ax1, ay1, bx0, by0)
    d4 = orient(ax0, ay0, ax1, ay1, bx1, by1)
    proper = ((d1 > eps) & (d2 < -eps) | (d1 < -eps) & (d2 > eps)) & (
        (d3 > eps) & (d4 < -eps) | (d3 < -eps) & (d4 > eps)
    )

    def on_seg(px, py, qx, qy, rx, ry):
        wx = (rx >= torch.minimum(px, qx) - eps) & (rx <= torch.maximum(px, qx) + eps)
        wy = (ry >= torch.minimum(py, qy) - eps) & (ry <= torch.maximum(py, qy) + eps)
        return wx & wy

    touch = (
        (torch.abs(d1) <= eps) & on_seg(bx0, by0, bx1, by1, ax0, ay0)
        | (torch.abs(d2) <= eps) & on_seg(bx0, by0, bx1, by1, ax1, ay1)
        | (torch.abs(d3) <= eps) & on_seg(ax0, ay0, ax1, ay1, bx0, by0)
        | (torch.abs(d4) <= eps) & on_seg(ax0, ay0, ax1, ay1, bx1, by1)
    )
    return proper | touch


def _check_shapes(node_table: Tensor, feats0: Tensor, alive0: Tensor, params: Tensor, k: int, l: int, c: int) -> int:
    if node_table.dim() != 3 or node_table.shape[2] != 4 * c:
        raise ValueError(f"node_table must be (G, N, {4 * c}), got {tuple(node_table.shape)}")
    g = node_table.shape[0]
    want = {"feats0": (g, feature_rows(l), k), "alive0": (g, k), "params": (g, N_PARAMS)}
    for name, tensor in (("feats0", feats0), ("alive0", alive0), ("params", params)):
        if tuple(tensor.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(tensor.shape)}")
    return g


def fused_beam_search_plain(
    node_table: Tensor,  # (G, N, 4C)
    feats0: Tensor,  # (G, F, K)
    alive0: Tensor,  # (G, K) f32 0/1
    params: Tensor,  # (G, N_PARAMS)
    *,
    k: int,
    l: int,
    c: int,
    weights: tuple,
    gates: dict,
) -> tuple[Tensor, Tensor]:
    """The kernel's arithmetic in plain PyTorch, operation for operation.
    Parents are (G, K) tensors, children (G, K, C). Returns (feats (G, F, K),
    alive (G, K))."""
    g = _check_shapes(node_table, feats0, alive0, params, k, l, c)
    (w0, w1, w2, w3, w6, ell_major, ell_minor, side_eps, cos_between, between_dist,
     thr_abs, thr_dir, close_dist, car_half, car_size, under_angle) = search_constants(weights, gates)
    dev = node_table.device
    pool = pool_size(k, c)

    s = lambda col: params[:, col][:, None, None]  # noqa: E731  per-search scalar -> (G, 1, 1)
    car_x, car_y, dir_x, dir_y = s(P_CARX), s(P_CARY), s(P_DIRX), s(P_DIRY)
    sign, target_len = s(P_SIGN), params[:, P_TLEN][:, None]

    # car body segment for gate 8
    dnrm = torch.rsqrt(torch.clamp(dir_x * dir_x + dir_y * dir_y, min=1e-30))
    cs_x = car_x - dir_x * dnrm * car_half
    cs_y = car_y - dir_y * dnrm * car_half
    ce_x = car_x + dir_x * dnrm * car_size
    ce_y = car_y + dir_y * dnrm * car_size

    ch = lambda a: a[:, :, None]  # noqa: E731  parent (G, K) -> (G, K, 1)
    pool_iota = torch.arange(pool, device=dev)
    feats, alive = feats0, alive0

    def partial_score(length, angle_sum, n_under, residual, init_cost, wrong_sum):
        n_int = torch.clamp(length - 2.0, min=1.0)
        return (
            _div(w0 * angle_sum, n_int) * (n_under + 1.0)
            + w1 * residual
            + _div(w2, torch.clamp(length, min=1.0))
            + w3 * init_cost
            + w6 * torch.abs(wrong_sum) * (length >= 4.0)
        )

    for _ in range(l - 1):
        configs = [feats[:, j] for j in range(l)]  # each (G, K)
        lengths = feats[:, l]
        done = feats[:, l + 1] > 0.5
        angle_sum, n_under = feats[:, l + 2], feats[:, l + 3]
        residual, init_cost = feats[:, l + 4], feats[:, l + 5]
        wrong_sum, last_idx = feats[:, l + 6], feats[:, l + 7]
        last_x, last_y = feats[:, l + 8], feats[:, l + 9]
        prev_x, prev_y = feats[:, l + 10], feats[:, l + 11]
        prev2_x, prev2_y = feats[:, l + 12], feats[:, l + 13]
        first_x, first_y = feats[:, l + 14], feats[:, l + 15]

        # ---- expansion: the node-table row of each beam's tail cone (a
        # negative index reads an all-zero row)
        row = gl.take_rows(node_table, torch.round(last_idx).to(torch.int64))  # (G, K, 4C)
        cand_idx = row[:, :, :c]
        can0 = row[:, :, c : 2 * c] > 0.5
        cand_x = row[:, :, 2 * c : 3 * c]
        cand_y = row[:, :, 3 * c :]

        p = lengths - 1.0

        # ---- gate 1: not already in config
        in_cfg = torch.zeros_like(can0)
        for j in range(l):
            in_cfg = in_cfg | (cand_idx == ch(configs[j]))
        can = can0 & ~in_cfg

        # ---- gate 2: ellipse (p >= 1)
        mjx, mjy = last_x - prev_x, last_y - prev_y
        inv = torch.rsqrt(torch.clamp(mjx * mjx + mjy * mjy, min=1e-24))
        mjx, mjy = mjx * inv, mjy * inv
        relx = cand_x - ch(last_x)
        rely = cand_y - ch(last_y)
        xr = relx * ch(mjx) + rely * ch(mjy)
        yr = ch(mjx) * rely - ch(mjy) * relx
        qx, qy = _div(xr, ell_major), _div(yr, ell_minor)
        ell = qx * qx + qy * qy < 1.0
        can = can & (ell | ch(p < 1.0))

        # ---- gate 3: second cone on the correct side (p == 0)
        ccx = cand_x - car_x
        ccy = cand_y - car_y
        dsign = atan2_plain(dir_x * ccy - dir_y * ccx, dir_x * ccx + dir_y * ccy)
        side_ok = (torch.sign(dsign) == sign) | (torch.abs(dsign) < side_eps)
        can = can & (side_ok | ch(p != 0.0))

        # ---- gate 4: no cone skipped between last and candidate; m runs
        # over the same neighbour set
        v_ml_x = ch(last_x) - cand_x  # (G, K, M) with M == C
        v_ml_y = ch(last_y) - cand_y
        d_ml = torch.sqrt(v_ml_x * v_ml_x + v_ml_y * v_ml_y)
        blocked = torch.zeros_like(can)
        for m in range(c):
            sl_m = slice(m, m + 1)
            vmcx = cand_x - cand_x[:, :, sl_m]
            vmcy = cand_y - cand_y[:, :, sl_m]
            d_mc = torch.sqrt(vmcx * vmcx + vmcy * vmcy)
            dots = v_ml_x[:, :, sl_m] * vmcx + v_ml_y[:, :, sl_m] * vmcy
            cos_gate = dots < cos_between * d_ml[:, :, sl_m] * d_mc
            not_self = cand_idx != cand_idx[:, :, sl_m]
            blocked = blocked | (
                can0[:, :, sl_m]
                & not_self
                & (d_mc < between_dist)
                & (d_ml[:, :, sl_m] < between_dist)
                & cos_gate
            )
        can = can & ~blocked

        # ---- gate 5: direction-change thresholds (p >= 1)
        spx, spy = last_x - prev_x, last_y - prev_y
        snx, sny = relx, rely
        diff = atan2_plain(ch(spx) * sny - ch(spy) * snx, ch(spx) * snx + ch(spy) * sny)
        seg_len = torch.sqrt(snx * snx + sny * sny)
        abs_ok = torch.abs(diff) <= thr_abs
        directional = (sign * diff < thr_dir) | (seg_len < close_dist)
        can = can & ((abs_ok & directional) | ch(p < 1.0))

        # ---- gate 6: flip-kill (p >= 2)
        ppx, ppy = prev_x - prev2_x, prev_y - prev2_y
        diff2 = ch(atan2_plain(ppx * spy - ppy * spx, ppx * spx + ppy * spy))
        flip = (torch.sign(diff) != torch.sign(diff2)) & (torch.abs(diff - diff2) > 1.3)
        can = can & (~flip | ch(p < 2.0))

        # ---- gate 7: offset from start (p == 1)
        off_ok = dir_x * (cand_x - ch(first_x)) + dir_y * (cand_y - ch(first_y)) > 0.0
        can = can & (off_ok | ch(p != 1.0))

        # ---- gate 8: car-body crossing
        crosses = _seg_intersect(ch(last_x), ch(last_y), cand_x, cand_y, cs_x, cs_y, ce_x, ce_y)
        can = can & ~crosses

        expandable = (alive > 0.5) & ~done & (lengths < target_len)
        can = can & ch(expandable)

        # ---- children carries
        theta = _angle_between(ch(prev_x) - ch(last_x), ch(prev_y) - ch(last_y), snx, sny)
        add_int = ch(p >= 1.0)
        zero = torch.zeros_like(theta)
        c_angle = ch(angle_sum) + torch.where(add_int, _div(math.pi - theta, math.pi), zero)
        c_under = ch(n_under) + (add_int & (theta < under_angle)).to(theta.dtype)
        c_resid = ch(residual) + torch.clamp(seg_len - 3.0, min=0.0)
        first_ang = _angle_between(cand_x - ch(first_x), cand_y - ch(first_y), dir_x, dir_y)
        c_init = torch.where(ch(p == 0.0), first_ang, ch(init_cost))
        wrong_inc = torch.where(
            (torch.sign(diff) == sign) & (torch.abs(diff) > under_angle), diff, zero
        )
        c_wrong = ch(wrong_sum) + torch.where(add_int, wrong_inc, zero)
        c_len = (ch(lengths) + 1.0).expand(g, k, c)
        c_score = partial_score(c_len, c_angle, c_under, c_resid, c_init, c_wrong)
        c_score = torch.where(can, c_score, torch.full_like(c_score, BIG))

        # ---- parents: freeze leaves
        newly_done = expandable & ~torch.any(can, dim=2)
        done2 = done | newly_done
        frozen = (alive > 0.5) & (done2 | ~expandable)
        p_score = partial_score(lengths, angle_sum, n_under, residual, init_cost, wrong_sum)
        p_score = torch.where(frozen, p_score, torch.full_like(p_score, BIG))

        # ---- pool (G, F, P): K parents, then the children j-major
        jm = lambda a: a.expand(g, k, c).transpose(1, 2).reshape(g, c * k)  # noqa: E731
        child_rows = [
            jm(torch.where(ch(lengths == float(j)), cand_idx, ch(configs[j]))) for j in range(l)
        ]
        child_rows += [
            jm(c_len), jm(zero), jm(c_angle), jm(c_under), jm(c_resid), jm(c_init), jm(c_wrong),
            jm(cand_idx), jm(cand_x), jm(cand_y), jm(ch(last_x)), jm(ch(last_y)),
            jm(ch(prev_x)), jm(ch(prev_y)), jm(ch(first_x)), jm(ch(first_y)),
        ]
        parent_feats = feats.clone()
        parent_feats[:, l + 1] = done2.to(feats.dtype)
        pool_feats = torch.cat([parent_feats, torch.stack(child_rows, dim=1)], dim=2)
        scores = torch.cat([p_score, jm(c_score)], dim=1)  # (G, P)

        # ---- exact top-K: rank(p) = #{q : (s_q, q) < (s_p, p)}; the entry
        # of rank r < K goes to slot r
        s_p, s_q = scores[:, :, None], scores[:, None, :]
        better = (s_q < s_p) | ((s_q == s_p) & (pool_iota[None, None, :] < pool_iota[None, :, None]))
        rank = torch.sum(better, dim=2)  # (G, P), a permutation of 0..P-1
        by_rank = torch.empty_like(rank).scatter_(1, rank, pool_iota[None, :].expand(g, pool))
        sel = by_rank[:, :k]
        feats = torch.take_along_dim(pool_feats, sel[:, None, :], dim=2)
        sel_scores = torch.take_along_dim(scores, sel, dim=1)
        valid = sel_scores < BIG * 0.5
        alive = valid.to(feats.dtype)

        # invalid slots: configs -1, length 0, done 0, last_idx -1
        v = valid[:, None, :]
        feats[:, :l] = torch.where(v, feats[:, :l], -1.0)
        feats[:, l : l + 2] = torch.where(v, feats[:, l : l + 2], 0.0)
        feats[:, l + 7 : l + 8] = torch.where(v, feats[:, l + 7 : l + 8], -1.0)

    return feats, alive


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


class _Consts(ctypes.Structure):
    """Mirror of ``Consts`` in csrc/beam_search.cu."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "w0", "w1", "w2", "w3", "w6", "ell_major", "ell_minor", "side_eps", "cos_between",
        "between_dist", "thr_abs", "thr_dir", "close_dist", "car_half", "car_size", "under_angle",
    )]


def _library() -> ctypes.CDLL:
    lib = kernel_build.load("beam_search")
    fn = lib.fused_beam_search_f32
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_Consts), ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def fused_beam_search_cuda(
    node_table: Tensor,
    feats0: Tensor,
    alive0: Tensor,
    params: Tensor,
    *,
    k: int,
    l: int,
    c: int,
    weights: tuple,
    gates: dict,
) -> tuple[Tensor, Tensor]:
    """Launch the CUDA kernel on the current stream (no synchronisation):
    one block per search, eight lanes per beam."""
    global launch_count
    require_kernel_shape(k, l, c)
    tensors = (node_table, feats0, alive0, params)
    if any(t.device.type != "cuda" or t.device != node_table.device for t in tensors):
        raise ValueError("fused_beam_search_cuda takes CUDA tensors on one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("fused_beam_search_cuda takes float32 tensors")
    g = _check_shapes(node_table, feats0, alive0, params, k, l, c)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("node_table, feats0, alive0 and params must be contiguous")
    missing = set(GATE_NAMES) - set(gates)
    if missing:
        raise ValueError(f"gates lack {sorted(missing)}")
    out_feats = torch.empty_like(feats0)
    out_alive = torch.empty_like(alive0)
    if g == 0:
        return out_feats, out_alive
    consts = _Consts(*search_constants(weights, gates))
    lib = _library()
    stream = torch.cuda.current_stream(node_table.device).cuda_stream
    with torch.cuda.device(node_table.device):
        err = lib.fused_beam_search_f32(
            node_table.data_ptr(), feats0.data_ptr(), alive0.data_ptr(), params.data_ptr(),
            out_feats.data_ptr(), out_alive.data_ptr(),
            g, node_table.shape[1], k, l, c, ctypes.byref(consts), stream,
        )
    if err != 0:
        raise RuntimeError(f"beam_search kernel launch failed: CUDA error {err}")
    launch_count += 1
    launch_count_by_instantiation[instantiation(k, l, c)] += 1
    return out_feats, out_alive


def fused_beam_search(
    node_table: Tensor,
    feats0: Tensor,
    alive0: Tensor,
    params: Tensor,
    *,
    k: int,
    l: int,
    c: int,
    weights: tuple,
    gates: dict,
) -> tuple[Tensor, Tensor]:
    """Run the whole beam search for G independent side-searches: returns
    (feats (G, F, K), alive (G, K)). CPU tensors take the plain version;
    any other the kernel, which raises at a shape it does not take."""
    run = fused_beam_search_plain if node_table.device.type == "cpu" else fused_beam_search_cuda
    return run(node_table, feats0, alive0, params, k=k, l=l, c=c, weights=weights, gates=gates)


# ---------------------------------------------------------------------------
# cost counters for the bound
# ---------------------------------------------------------------------------

_ATAN2_OPS = 30  # abs, min/max, 2 divisions, 10 polynomial ops, compares and selects


def search_flops(n: int, k: int, l: int, c: int) -> int:
    """Float32 operations one search needs, whatever computes it: the gates,
    carries and score of every child, the score of every parent, and an exact
    top-K of the pool by comparison (``P * ceil(log2 P)`` compares, a sort's
    worth). Arithmetic, comparisons and selects each count one; copying
    feature rows is data movement and counts nothing. How the kernel selects
    (it sorts 64-bit keys within each warp and searches the sorted lists) is
    its own choice and is not counted here, so the bound does not move when
    the kernel changes. Independent of ``n`` (a
    tail's table row is indexed, not searched) and of the data (no early
    exit)."""
    del n
    child = (
        2 * l  # gate 1: compare, or
        + 22  # gate 2
        + 10 + _ATAN2_OPS  # gate 3
        + 5 * c + 19 * c  # gate 4: distances to last, then the pairwise test
        + 12 + _ATAN2_OPS  # gate 5
        + 6  # gate 6 (diff2 is counted with the parent)
        + 8  # gate 7
        + 60  # gate 8: four orientations, proper and touching tests
        + 2 * (8 + _ATAN2_OPS)  # theta, first_ang
        + 14  # carries
        + 16  # score
    )
    parent = 16 + 10 + _ATAN2_OPS + 12  # score, tail geometry, diff2, freezing
    pool = pool_size(k, c)
    select = pool * math.ceil(math.log2(pool))
    return (l - 1) * (k * c * child + k * parent + select)


def search_bytes(g: int, n: int, k: int, l: int, c: int) -> int:
    """Bytes one call must move: each input read once, each output written
    once, float32."""
    state = feature_rows(l) * k + k
    return 4 * g * (n * 4 * c + state + N_PARAMS + state)
