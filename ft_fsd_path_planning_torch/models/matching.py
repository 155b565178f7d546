"""Cone matching stage — masked pairwise scoring + virtual cone synthesis.

Counterpart of `ft_fsd_path_planning_tpu/models/matching.py` (reference
`cone_matching/functional_cone_matching.py:32-588`): per-cone loops become
(B, M, N) masked score tensors and the sequential virtual-cone insertion a
loop of branchless shift-inserts over a fixed buffer. Tie order follows the
JAX package: stable sorts, lowest index first.

:func:`run_cone_matching` chooses from the device alone: on the CPU the
plain PyTorch version (:func:`run_cone_matching_plain`), on the card the
hand-written kernel ``csrc/cone_matching.cu``, one launch for the whole
stage (:func:`run_cone_matching_cuda`), which raises at a side length it
does not take; a planner for the card raises already when it is made
(:func:`require_kernel_shape`).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ft_fsd_path_planning_torch.config import PlannerConfig
from ft_fsd_path_planning_torch.ops import gatherless as gl
from ft_fsd_path_planning_torch.ops import geometry as geo
from ft_fsd_path_planning_torch.ops import kernel_build
from ft_fsd_path_planning_torch.ops.beam_search import UnsupportedShape
from ft_fsd_path_planning_torch.utils import timer
from ft_fsd_path_planning_torch.utils.cone_types import ConeTypes
from ft_fsd_path_planning_torch.utils.timer import spanned

Tensor = torch.Tensor

#: side lengths S the kernel takes: one warp a lane of the batch, one slot a
#: thread up to 32 and two up to 64 (the plain version needs S >= 2)
KERNEL_MIN_SIDE, KERNEL_MAX_SIDE = 2, 64

#: launches of the CUDA kernel since the last reset (plain calls do not count)
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def kernel_supports(side_len: int) -> bool:
    """Whether the CUDA kernel takes sides of ``side_len`` slots."""
    return KERNEL_MIN_SIDE <= side_len <= KERNEL_MAX_SIDE


def require_kernel_shape(side_len: int) -> None:
    """Raise :class:`UnsupportedShape` unless the kernel takes ``side_len``."""
    if not kernel_supports(side_len):
        raise UnsupportedShape(
            f"the matching kernel does not take side_len {side_len}: "
            f"{KERNEL_MIN_SIDE} <= side_len <= {KERNEL_MAX_SIDE}"
        )


class MatchingInput(NamedTuple):
    """Sorted left/right traces (reference ConeMatchingInput)."""

    left_cones: Tensor  # (B, S, 2)
    left_mask: Tensor  # (B, S)
    right_cones: Tensor  # (B, S, 2)
    right_mask: Tensor  # (B, S)
    position: Tensor  # (B, 2)
    direction: Tensor  # (B, 2)


class MatchingOutput(NamedTuple):
    left_cones: Tensor  # (B, S, 2) with virtual cones inserted
    left_mask: Tensor
    left_virtual_mask: Tensor
    right_cones: Tensor
    right_mask: Tensor
    right_virtual_mask: Tensor
    left_to_right: Tensor  # (B, S) int, -1 = unmatched
    right_to_left: Tensor


def _norm(v: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def match_search_directions(cones: Tensor, mask: Tensor, cone_type: int) -> Tensor:
    """Normals of the prev->next chords, rotated to point across the track
    (reference match_directions.py:7-44). Endpoints use one-sided chords."""
    s = cones.shape[1]
    n = torch.sum(mask, dim=1)
    i = torch.arange(s, device=cones.device)[None, :]
    first = (i == 0)[..., None]
    last = ((i == (n - 1)[:, None]) & (n >= 2)[:, None])[..., None]
    prev = torch.cat([cones[:, :1], cones[:, :-1]], dim=1)
    nxt = torch.cat([cones[:, 1:], cones[:, -1:]], dim=1)
    ends = gl.take_rows(
        cones,
        torch.clamp(torch.stack([n - 2, n - 1, torch.clamp(n - 1, max=1)], dim=1), 0, s - 1),
    )  # [cones[n-2], cones[n-1], cones[min(1, n-1)]]
    a = torch.where(first, cones[:, :1], torch.where(last, ends[:, 0:1], prev))
    b = torch.where(first, ends[:, 2:3], torch.where(last, ends[:, 1:2], nxt))
    track_dir = b - a
    rotation = math.pi / 2 if cone_type == ConeTypes.RIGHT else -math.pi / 2
    d = geo.rotate(track_dir, rotation)
    return geo.normalize_last_axis(d)


def _two_smallest(dist: Tensor) -> Tensor:
    """Indices of the two smallest entries along the last axis, lowest index
    first on ties (the order of `lax.top_k(-dist, 2)`)."""
    return torch.sort(dist, dim=-1, stable=True).indices[..., :2]


def potential_matches_mask(
    cones: Tensor,
    cones_mask: Tensor,
    directions: Tensor,
    other: Tensor,
    other_mask: Tensor,
    other_directions: Tensor,
    major_radius: float,
    minor_radius: float,
    max_search_angle: float,
) -> Tensor:
    """(B, M, N) candidate mask: rotated-ellipse membership, half-angle gate
    and direction-opposition gate, then only the 2 nearest candidates per
    cone are kept."""
    vec = other[:, None, :, :] - cones[:, :, None, :]  # (B, M, N, 2)
    ang = geo.angle_from_2d_vector(directions)  # (B, M)
    rotated = geo.rotate(vec, -ang[:, :, None])
    ellipse = (rotated[..., 0] / major_radius) ** 2 + (rotated[..., 1] / minor_radius) ** 2 < 1.0

    rot_angle = geo.angle_from_2d_vector(rotated)
    angle_ok = torch.abs(rot_angle / 2.0) <= max_search_angle

    dir_diff = geo.vec_angle_between(directions[:, :, None, :], other_directions[:, None, :, :])
    opposition_ok = dir_diff >= math.pi / 2

    valid = cones_mask[:, :, None] & other_mask[:, None, :]
    mask = ellipse & angle_ok & opposition_ok & valid

    # keep only the 2 closest candidates per cone: 2 argmin-extract rounds
    dist = torch.where(mask, _norm(vec), torch.full_like(rot_angle, math.inf))
    n = mask.shape[2]
    iota = torch.arange(n, device=cones.device)
    keep = torch.zeros_like(mask)
    cur = dist
    for _ in range(2):
        mn = torch.amin(cur, dim=2)
        pick = torch.argmin(cur, dim=2)
        hit = iota == pick[..., None]
        keep = keep | (hit & torch.isfinite(mn)[..., None])
        cur = torch.where(hit, torch.full_like(cur, math.inf), cur)
    return keep & mask


def select_best_match(
    cones: Tensor,
    cones_mask: Tensor,
    match_mask: Tensor,
    other: Tensor,
    other_mask: Tensor,
    monotonic: bool,
) -> Tensor:
    """Best match per cone = argmin distance over the whole other side, -1
    when the cone has no candidates (the argmin deliberately ignores the
    candidate mask, as the reference does)."""
    d2 = geo.cdist_sq(cones, other)
    d2 = torch.where(other_mask[:, None, :], d2, torch.full_like(d2, math.inf))
    matched = torch.argmin(d2, dim=2)

    if monotonic:
        cummax = torch.cummax(matched, dim=1).values
        prev_cummax = torch.roll(cummax, 1, dims=1)
        prev_cummax[:, 0] = matched[:, 0]
        matched = torch.where(matched >= prev_cummax, matched, -1)

    has_candidate = torch.any(match_mask, dim=2)
    no_other = (torch.sum(other_mask, dim=1) == 0)[:, None]
    return torch.where(cones_mask & has_candidate & ~no_other, matched, -1)


def _insert_virtual_cones(
    existing: Tensor,
    existing_count: Tensor,
    to_insert: Tensor,
    insert_mask: Tensor,
    car_position: Tensor,
) -> tuple[Tensor, Tensor]:
    """Sequential shift-insert of virtual cones into an ordered trace
    (reference insert_virtual_cones_to_existing, :195-261). The loop stops
    after the last insertion slot any lane uses (one host sync)."""
    s = existing.shape[1]
    dev = existing.device
    iota = torch.arange(s, device=dev)[None, :]

    # insertion order: ascending min-distance to the existing cones (stable)
    d2 = geo.cdist_sq(to_insert, existing)
    d2 = torch.where(iota[:, None, :] < existing_count[:, None, None], d2, torch.full_like(d2, math.inf))
    min_d = torch.where(insert_mask, torch.amin(d2, dim=2), torch.full_like(d2[..., 0], math.inf))
    order = torch.argsort(min_d, dim=1, stable=True)
    to_insert = gl.take_rows(to_insert, order)
    insert_mask = torch.take_along_dim(insert_mask, order, dim=1)

    v = insert_mask.shape[1]
    slot_used = torch.any(insert_mask, dim=0) * torch.arange(1, v + 1, device=dev)
    n_trips = int(torch.max(slot_used))

    buf, count = existing, existing_count
    for k in range(n_trips):
        cone = to_insert[:, k]
        do = insert_mask[:, k]

        valid = iota < count[:, None]
        dist = torch.where(valid, _norm(buf - cone[:, None]), torch.full_like(buf[..., 0], math.inf))
        two = _two_smallest(dist)
        closest, second = two[:, 0], two[:, 1]
        near2 = gl.take_rows(buf, two)

        # single existing cone: insert by car distance
        d_cone = _norm(cone - car_position)
        d_exist = _norm(buf[:, 0] - car_position)
        idx_single = torch.where(d_cone < d_exist, 0, 1)

        adjacent = torch.abs(closest - second) == 1
        between = geo.vec_angle_between(near2[:, 0] - cone, near2[:, 1] - cone) > math.pi / 2
        idx_multi = torch.where(
            between,
            torch.minimum(closest, second) + 1,
            torch.where(closest < second, closest, closest + 1),
        )

        idx = torch.where(count == 1, idx_single, idx_multi)[:, None]
        do = (do & ((count == 1) | adjacent) & (count < s))[:, None]

        buf_shift = torch.cat([buf[:, :1], buf[:, :-1]], dim=1)
        shifted = torch.where(((iota > idx) & do)[..., None], buf_shift, buf)
        buf = torch.where(((iota == idx) & do)[..., None], cone[:, None], shifted)
        count = count + do[:, 0].to(count.dtype)
    return buf, count


def combine_and_sort_virtual_with_real(
    other_cones: Tensor,
    other_mask: Tensor,
    virtual_cones: Tensor,
    virtual_mask: Tensor,
    car_position: Tensor,
) -> tuple[Tensor, Tensor, Tensor]:
    """Merge virtual cones into the real other-side trace, drop sharp
    (< 85 deg) kinks, flag virtuals by distance. Returns (cones, mask,
    is_virtual)."""
    s = other_cones.shape[1]
    dev = other_cones.device
    n_other = torch.sum(other_mask, dim=1)
    n_virtual = torch.sum(virtual_mask, dim=1)

    # larger array hosts, smaller is inserted; ties host the virtuals
    other_hosts = n_other > n_virtual
    oh = other_hosts[:, None]
    host = torch.where(oh[..., None], other_cones, virtual_cones)
    host_count = torch.where(other_hosts, n_other, n_virtual)
    ins = torch.where(oh[..., None], virtual_cones, other_cones)
    ins_mask = torch.where(oh, virtual_mask, other_mask)

    merged, merged_count = _insert_virtual_cones(host, host_count, ins, ins_mask, car_position)
    mc = merged_count[:, None]
    merged_mask = torch.arange(s, device=dev)[None, :] < mc

    # remove sharp kinks — interior angles < 85 deg
    angles = geo.trace_angles_between(merged)  # (B, s-2)
    interior = (torch.arange(1, s - 1, device=dev)[None, :] < mc - 1) & (mc >= 3)
    no = torch.zeros_like(merged_mask[:, :1])
    low = torch.cat([no, (angles < geo.deg2rad(85.0)) & interior, no], dim=1)
    keep = merged_mask & ~low
    order, valid = geo.stable_compact(keep)
    merged = gl.take_rows(merged, order)
    merged_mask = valid

    # virtual flag: farther than epsilon from every real cone
    d2 = geo.cdist_sq(merged, other_cones)
    d2 = torch.where(other_mask[:, None, :], d2, torch.full_like(d2, math.inf))
    is_virtual = merged_mask & (torch.amin(d2, dim=2) > 1e-4)

    # degenerate cases
    no_other = (n_other == 0)[:, None]
    no_virtual = (n_virtual == 0)[:, None]
    cones_out = torch.where(
        no_other[..., None], virtual_cones, torch.where(no_virtual[..., None], other_cones, merged)
    )
    mask_out = torch.where(no_other, virtual_mask, torch.where(no_virtual, other_mask, merged_mask))
    virt_out = torch.where(no_other, virtual_mask, no_virtual.logical_not() & is_virtual)
    return cones_out, mask_out, virt_out


def _matches_for_side(
    cfg: PlannerConfig,
    cones: Tensor,
    cones_mask: Tensor,
    cone_type: int,
    other: Tensor,
    other_mask: Tensor,
) -> tuple[Tensor, Tensor]:
    """Reference calculate_matches_for_side. Returns (matches (B, S),
    search_directions (B, S, 2))."""
    m = cfg.matching
    dirs = match_search_directions(cones, cones_mask, cone_type)
    other_type = ConeTypes.LEFT if cone_type == ConeTypes.RIGHT else ConeTypes.RIGHT
    other_dirs = match_search_directions(other, other_mask, other_type)
    # the other side needs > 1 cones for directions, else zeros
    other_dirs = torch.where(
        (torch.sum(other_mask, dim=1) > 1)[:, None, None], other_dirs, torch.zeros_like(other_dirs)
    )
    cand = potential_matches_mask(
        cones, cones_mask, dirs, other, other_mask, other_dirs,
        m.major_radius, m.minor_radius, m.max_search_angle,
    )
    matches = select_best_match(
        cones, cones_mask, cand, other, other_mask, m.matches_should_be_monotonic
    )
    # sides with < 2 cones produce no matches
    matches = torch.where((torch.sum(cones_mask, dim=1) > 1)[:, None], matches, -1)
    return matches, dirs


def _cones_for_other_side(
    cfg: PlannerConfig,
    cones: Tensor,
    cones_mask: Tensor,
    cone_type: int,
    other: Tensor,
    other_mask: Tensor,
    position: Tensor,
) -> tuple[Tensor, Tensor, Tensor]:
    """Reference calculate_cones_for_other_side (:387-440)."""
    matches, dirs = _matches_for_side(cfg, cones, cones_mask, cone_type, other, other_mask)

    unmatched = (matches == -1) & cones_mask
    virtual = cones + dirs * cfg.matching.min_track_width
    order, virt_valid = geo.stable_compact(unmatched)
    virtual = gl.take_rows(virtual, order)

    combined, combined_mask, is_virtual = combine_and_sort_virtual_with_real(
        other, other_mask, virtual, virt_valid, position
    )

    # < 2 combined -> keep the plain other side; this side needs >= 2 cones
    # to produce virtuals at all
    plain = ((torch.sum(combined_mask, dim=1) < 2) | (torch.sum(cones_mask, dim=1) < 2))[:, None]
    combined = torch.where(plain[..., None], other, combined)
    combined_mask = torch.where(plain, other_mask, combined_mask)
    is_virtual = ~plain & is_virtual
    return combined, combined_mask, is_virtual


def run_cone_matching_plain(cfg: PlannerConfig, inp: MatchingInput) -> MatchingOutput:
    """Reference calculate_virtual_cones_for_both_sides (:479-588)."""
    n_l = torch.sum(inp.left_mask, dim=1)
    n_r = torch.sum(inp.right_mask, dim=1)

    # side-discard guard
    min_len = torch.minimum(n_l, n_r)
    max_len = torch.maximum(n_l, n_r)
    discard = (min_len == 0) | (max_len > 2 * min_len)
    drop_left = discard & (n_l < n_r)
    drop_right = discard & ~(n_l < n_r)

    left_mask = inp.left_mask & ~drop_left[:, None]
    right_mask = inp.right_mask & ~drop_right[:, None]

    right_w, right_w_mask, right_virt = _cones_for_other_side(
        cfg, inp.left_cones, left_mask, ConeTypes.LEFT,
        inp.right_cones, right_mask, inp.position,
    )
    left_w, left_w_mask, left_virt = _cones_for_other_side(
        cfg, inp.right_cones, right_mask, ConeTypes.RIGHT,
        inp.left_cones, left_mask, inp.position,
    )

    l2r, _ = _matches_for_side(cfg, left_w, left_w_mask, ConeTypes.LEFT, right_w, right_w_mask)
    r2l, _ = _matches_for_side(cfg, right_w, right_w_mask, ConeTypes.RIGHT, left_w, left_w_mask)

    # both sides < 2 -> empty result
    live = ~((n_l < 2) & (n_r < 2))[:, None]
    return MatchingOutput(
        left_cones=left_w,
        left_mask=live & left_w_mask,
        left_virtual_mask=live & left_virt,
        right_cones=right_w,
        right_mask=live & right_w_mask,
        right_virtual_mask=live & right_virt,
        left_to_right=torch.where(live, l2r, -1),
        right_to_left=torch.where(live, r2l, -1),
    )


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


class _Consts(ctypes.Structure):
    """Mirror of ``Consts`` in csrc/cone_matching.cu: the constants of the
    plain version as float32 operands on the card. A division by a Python
    scalar runs there as a product with its float32 reciprocal."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "inv_major", "inv_minor", "max_angle", "track_width", "half_pi", "kink", "virt_eps", "eps",
    )] + [("monotonic", ctypes.c_int)]


def kernel_consts(cfg: PlannerConfig) -> _Consts:
    m = cfg.matching
    one = np.float32(1.0)
    return _Consts(
        float(one / np.float32(m.major_radius)), float(one / np.float32(m.minor_radius)),
        m.max_search_angle, m.min_track_width, math.pi / 2, geo.deg2rad(85.0), 1e-4, 1e-12,
        int(m.matches_should_be_monotonic),
    )


def kernel_bytes(b: int, s: int) -> int:
    """Bytes the kernel must move: two sides of (x, y, mask) and the car's
    position in; two sides of (x, y, mask, virtual flag, int64 match) out."""
    return b * (2 * s * (8 + 1) + 8 + 2 * s * (8 + 1 + 1 + 8))


def kernel_flops(b: int, s: int) -> int:
    """Operations the kernel needs, counted from its arithmetic: four passes
    over the S x S (cone, other cone) pairs at ~70 each (rotation, ellipse,
    atan2, the opposition's acos, the squared distance), and the two merges'
    S x S distances for the insertion order and S trips over S slots, ~25 a
    pair."""
    return b * (4 * s * s * 70 + 2 * s * s * 25)


def _library() -> ctypes.CDLL:
    lib = kernel_build.load("cone_matching")
    fn = lib.cone_matching_f32
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int, ctypes.c_int, ctypes.POINTER(_Consts), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def run_cone_matching_cuda(cfg: PlannerConfig, inp: MatchingInput) -> MatchingOutput:
    """Launch the CUDA kernel on the current stream (no synchronisation): one
    warp a lane of the batch, the whole stage in one launch."""
    global launch_count
    if inp.left_cones.dim() != 3:
        raise ValueError(f"left_cones must be (B, S, 2), got {tuple(inp.left_cones.shape)}")
    b, s = inp.left_cones.shape[:2]
    require_kernel_shape(s)
    tensors = (inp.left_cones, inp.left_mask, inp.right_cones, inp.right_mask, inp.position)
    want = ((b, s, 2), (b, s), (b, s, 2), (b, s), (b, 2))
    names = ("left_cones", "left_mask", "right_cones", "right_mask", "position")
    for name, tensor, shape in zip(names, tensors, want):
        if tuple(tensor.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(tensor.shape)}")
    for name, tensor in zip(names, tensors):
        dtype = torch.bool if name.endswith("mask") else torch.float32
        if tensor.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {tensor.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the cones, masks and position must be contiguous")
    dev = inp.left_cones.device
    if any(t.device.type != "cuda" or t.device != dev for t in tensors):
        raise ValueError("run_cone_matching_cuda takes CUDA tensors on one device")
    cones = [torch.empty((b, s, 2), dtype=torch.float32, device=dev) for _ in range(2)]
    masks = [torch.empty((b, s), dtype=torch.bool, device=dev) for _ in range(4)]
    matches = [torch.empty((b, s), dtype=torch.int64, device=dev) for _ in range(2)]
    out = MatchingOutput(
        left_cones=cones[0], left_mask=masks[0], left_virtual_mask=masks[1],
        right_cones=cones[1], right_mask=masks[2], right_virtual_mask=masks[3],
        left_to_right=matches[0], right_to_left=matches[1],
    )
    if b == 0:
        return out
    consts = kernel_consts(cfg)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.cone_matching_f32(
            *(t.data_ptr() for t in tensors), *(t.data_ptr() for t in out),
            b, s, ctypes.byref(consts), stream,
        )
    if err != 0:
        raise RuntimeError(f"cone_matching kernel launch failed: CUDA error {err}")
    launch_count += 1
    timer.count("matching.kernel.launches")  # one a launch, no sync
    return out


@spanned("stage.matching.run")
def run_cone_matching(cfg: PlannerConfig, inp: MatchingInput) -> MatchingOutput:
    """The matching stage: the plain version for CPU tensors, the kernel for
    any other, which raises at a side length it does not take."""
    if inp.left_cones.device.type == "cpu":
        return run_cone_matching_plain(cfg, inp)
    return run_cone_matching_cuda(cfg, MatchingInput(*(t.contiguous() for t in inp)))
