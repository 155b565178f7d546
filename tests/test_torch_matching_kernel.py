"""The matching stage's dispatch and the kernel's wrapper, on the CPU: CPU
tensors take the plain version and launch nothing; any other device takes
the kernel, whose wrapper refuses what the kernel does not take before it
launches; a planner for the card refuses a side length the kernel does not
take. The plain version's insertion loop gives each lane alone what it
gives that lane in a mixed batch, the property the kernel's per-lane loop
rests on. The judgement of `tests/matching_check.py`, which holds the
kernel to the plain version on the card, is held here on plain results
made wrong on purpose.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ft_fsd_path_planning_torch.config import default_config
from ft_fsd_path_planning_torch.models import facade
from ft_fsd_path_planning_torch.models import matching as tm
from ft_fsd_path_planning_torch.ops import geometry as geo
from ft_fsd_path_planning_torch.ops.beam_search import UnsupportedShape
from ft_fsd_path_planning_torch.utils import timer
from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes
from tests import matching_check as mc

torch.set_num_threads(1)

SIDES = (16, 32, 64)


def _cfg(s: int):
    base = default_config(n_cones=128)
    return dataclasses.replace(base, shapes=dataclasses.replace(base.shapes, side_len=s))


@pytest.mark.parametrize("s", SIDES)
def test_cpu_takes_the_plain_version_and_launches_nothing(s):
    cfg = _cfg(s)
    _, inp = mc.edge_input(s, "cpu", full=True)
    tm.reset_launch_count()
    timer.reset()
    with timer.recording():
        got = tm.run_cone_matching(cfg, inp)
        table = timer.table()
    want = tm.run_cone_matching_plain(cfg, inp)
    assert tm.launch_count == 0
    assert table.get("matching.kernel.launches", 0) == 0
    assert table["stage.matching.run"]["n"] == 1
    for name in tm.MatchingOutput._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert got.left_to_right.dtype == torch.int64


@pytest.mark.parametrize("s", [2, 32, 64, 65])
def test_dispatch_off_the_cpu_takes_the_kernel(monkeypatch, s):
    """Off the CPU (a meta tensor stands for the card's) the stage takes the
    kernel's wrapper, with contiguous inputs; the wrapper refuses a side
    length outside [2, 64] before it launches anything."""
    assert tm.kernel_supports(s) is (2 <= s <= 64)
    calls = []
    monkeypatch.setattr(tm, "run_cone_matching_cuda", lambda cfg, inp: calls.append(inp))
    monkeypatch.setattr(tm, "run_cone_matching_plain", lambda cfg, inp: calls.append("plain"))
    left = torch.empty((3, 2, s), device="meta").transpose(1, 2)  # not contiguous
    mask = torch.empty((3, s), dtype=torch.bool, device="meta")
    pos = torch.empty((3, 2), device="meta")
    tm.run_cone_matching(_cfg(s), tm.MatchingInput(left, mask, left, mask, pos, pos))
    assert len(calls) == 1 and calls[0] != "plain"
    assert all(t.is_contiguous() for t in calls[0])
    monkeypatch.undo()
    tm.reset_launch_count()
    if not tm.kernel_supports(s):
        with pytest.raises(UnsupportedShape, match="does not take"):
            tm.run_cone_matching(_cfg(s), tm.MatchingInput(left.contiguous(), mask, left.contiguous(), mask, pos, pos))
    assert tm.launch_count == 0


def _good_input(b: int = 3, s: int = 32) -> tm.MatchingInput:
    rng = np.random.default_rng(0)
    cones = lambda: torch.tensor(rng.normal(size=(b, s, 2)), dtype=torch.float32)  # noqa: E731
    mask = torch.ones((b, s), dtype=torch.bool)
    pos = torch.zeros((b, 2))
    return tm.MatchingInput(cones(), mask, cones(), mask.clone(), pos, pos.clone())


#: inputs the wrapper refuses, and what it says
REFUSED = {
    "side of 65": (lambda i: i._replace(left_cones=torch.zeros(3, 65, 2), right_cones=torch.zeros(3, 65, 2),
                                        left_mask=torch.ones(3, 65, dtype=torch.bool),
                                        right_mask=torch.ones(3, 65, dtype=torch.bool)),
                   UnsupportedShape, "does not take side_len 65"),
    "side of 1": (lambda i: i._replace(left_cones=i.left_cones[:, :1].contiguous(),
                                       right_cones=i.right_cones[:, :1].contiguous(),
                                       left_mask=i.left_mask[:, :1].contiguous(),
                                       right_mask=i.right_mask[:, :1].contiguous()),
                  UnsupportedShape, "does not take side_len 1"),
    "float64 cones": (lambda i: i._replace(left_cones=i.left_cones.double()), TypeError, "left_cones must be torch.float32"),
    "uint8 mask": (lambda i: i._replace(right_mask=i.right_mask.to(torch.uint8)), TypeError, "right_mask must be torch.bool"),
    "float64 position": (lambda i: i._replace(position=i.position.double()), TypeError, "position must be"),
    "not contiguous": (lambda i: i._replace(right_cones=i.right_cones.transpose(1, 2).contiguous().transpose(1, 2)),
                       ValueError, "contiguous"),
    "mismatched B": (lambda i: i._replace(right_mask=i.right_mask[:2]), ValueError, r"right_mask must be \(3, 32\)"),
    "mismatched S": (lambda i: i._replace(right_cones=i.right_cones[:, :16].contiguous()), ValueError, "right_cones must be"),
    "no (B, S, 2) cones": (lambda i: i._replace(left_cones=i.left_cones[0]), ValueError, r"left_cones must be \(B, S, 2\)"),
    "CPU tensors": (lambda i: i, ValueError, "CUDA tensors"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(case):
    make, error, message = REFUSED[case]
    inp = make(_good_input())
    tm.reset_launch_count()
    with pytest.raises(error, match=message):
        tm.run_cone_matching_cuda(_cfg(32), inp)
    assert tm.launch_count == 0


@pytest.mark.parametrize("s", [16, 32, 64, 65])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_planner_refuses_a_side_length_the_kernel_does_not_take(monkeypatch, device, s):
    """A planner for the card (a meta device stands for it) raises
    UnsupportedShape at side_len 65, beside B2's check; on the CPU every
    side length runs the plain version."""
    monkeypatch.setattr(facade, "make_initial_state", lambda cfg, batch, dev: None)
    cfg = _cfg(s)
    if device != "cpu" and s > 64:
        with pytest.raises(UnsupportedShape, match="matching kernel does not take side_len 65"):
            facade.PathPlanner(MissionTypes.trackdrive, config=cfg, device=device)
    else:
        assert facade.PathPlanner(MissionTypes.trackdrive, config=cfg, device=device).cfg == cfg


def _insert_case(s: int, b: int = 24, seed: int = 5):
    """Mixed lanes for `_insert_virtual_cones`: traces of 1 to s - 1 cones,
    0 to s insertees with masks that leave holes, so that the lanes' own
    trip counts differ."""
    rng = np.random.default_rng(seed + s)
    existing = np.zeros((b, s, 2), np.float32)
    counts = rng.integers(1, s, b)
    to_insert = rng.normal(0.0, 8.0, (b, s, 2)).astype(np.float32)
    insert_mask = np.zeros((b, s), bool)
    for i in range(b):
        existing[i, : counts[i]] = mc._arc(int(counts[i]), 1.5, radius=25.0)
        existing[i, counts[i]:] = rng.normal(0.0, 30.0, (s - counts[i], 2))
        n_ins = int(rng.integers(0, s + 1)) if i else 0
        insert_mask[i, rng.permutation(s)[:n_ins]] = True
        to_insert[i] += mc._arc(s, -1.5, radius=25.0, step=3.5 * counts[i] / s)
    pos = rng.normal(0.0, 2.0, (b, 2)).astype(np.float32)
    t = torch.tensor
    return t(existing), t(counts), t(to_insert), t(insert_mask), t(pos)


@pytest.mark.parametrize("s", SIDES)
def test_insertion_of_a_lane_alone_equals_the_lane_in_a_mixed_batch(s):
    """`_insert_virtual_cones` on each lane alone (B = 1: its own trip
    count) gives exactly what the batch gives that lane (the batch's trip
    count, the largest): the trips past a lane's own last one change
    nothing there."""
    existing, counts, to_insert, insert_mask, pos = _insert_case(s)
    buf, count = tm._insert_virtual_cones(existing, counts, to_insert, insert_mask, pos)
    inserted = count - counts
    assert int(inserted.max()) > int(inserted.min()), "the lanes should insert different numbers of cones"
    for i in range(existing.shape[0]):
        one = slice(i, i + 1)
        buf_i, count_i = tm._insert_virtual_cones(existing[one], counts[one], to_insert[one], insert_mask[one], pos[one])
        assert torch.equal(buf_i[0], buf[i]) and int(count_i[0]) == int(count[i]), i


@pytest.mark.parametrize("s", SIDES)
def test_stage_of_a_lane_alone_equals_the_lane_in_the_batch(s):
    """The whole plain stage, lane by lane against the batch of edge lanes:
    nothing of one lane reaches another."""
    for cfg in mc.edge_configs(s).values():
        _, inp = mc.edge_input(s, "cpu", full=True)
        batch = tm.run_cone_matching_plain(cfg, inp)
        for i in range(inp.left_cones.shape[0]):
            one = tm.run_cone_matching_plain(cfg, tm.MatchingInput(*(t[i : i + 1] for t in inp)))
            for name in tm.MatchingOutput._fields:
                assert torch.equal(getattr(one, name)[0], getattr(batch, name)[i]), (i, name)


def test_edge_lanes_exercise_what_they_are_named_for():
    """The card's edge lanes (plain version, CPU): sides of 0, 1 and 2
    cones, the discard guard, no virtual cones, every cone unmatched, a
    merge past a side of 16 slots, monotonic matches on and off."""
    names, inp = mc.edge_input(16, "cpu", full=True)
    lane = {n: i for i, n in enumerate(names)}
    cfgs = list(mc.edge_configs(16).values())
    out = tm.run_cone_matching_plain(cfgs[0], inp)
    n_left, n_right = out.left_mask.sum(1), out.right_mask.sum(1)
    virtual = out.left_virtual_mask.sum(1) + out.right_virtual_mask.sum(1)
    assert n_left[lane["one cone a side"]] == n_right[lane["one cone a side"]] == 0
    assert int(n_left[lane["left side empty"]]) == int(out.left_virtual_mask.sum(1)[lane["left side empty"]]) == 5
    assert int(out.left_virtual_mask.sum(1)[lane["discard guard, left 3 right 10"]]) == 10
    assert int(out.right_virtual_mask.sum(1)[lane["discard guard, left 9 right 4"]]) == 9
    for name in ("no virtual cones: straight pairs", "no virtual cones: arc pairs", "full sides"):
        assert int(virtual[lane[name]]) == 0 and bool(out.left_to_right[lane[name]][out.left_mask[lane[name]]].ge(0).all())
    unmatched = lane["every cone unmatched"]
    # 12 real and 12 virtual cones into 16 slots, then the kinks go
    assert 12 < int(n_left[unmatched]) <= 16 and bool((out.left_to_right[unmatched] == -1).all())
    assert int(out.right_virtual_mask.sum(1)[lane["three missing on the right"]]) >= 3
    mono = tm.run_cone_matching_plain(cfgs[1], inp)
    assert cfgs[1].matching.matches_should_be_monotonic and not cfgs[0].matching.matches_should_be_monotonic
    swapped = lane["two right cones swapped"]
    assert any(not torch.equal(getattr(mono, f)[swapped], getattr(out, f)[swapped]) for f in tm.MatchingOutput._fields)


def _wrong(out: tm.MatchingOutput, **changes) -> tm.MatchingOutput:
    return out._replace(**{k: v(getattr(out, k)) for k, v in changes.items()})


def _flip_lane3(m):
    m = m.clone()
    m[3, 0] = ~m[3, 0]
    return m


def _shift_match(m):
    m = m.clone()
    m[5, 1] += 1
    return m


JUDGED = {
    "the plain version itself": ({}, []),
    "cones 1e-6 m off": ({"left_cones": lambda c: c + 1e-6}, []),
    "cones 1e-4 m off": ({"right_cones": lambda c: c + 1e-4}, ["right_cones off by"]),
    "a NaN cone": ({"left_cones": lambda c: c.index_fill(0, torch.tensor([2]), float("nan"))}, ["left_cones off by nan"]),
    "a mask flipped": ({"left_mask": _flip_lane3}, ["left_mask differs on lanes [3]"]),
    "a virtual flag flipped": ({"right_virtual_mask": _flip_lane3}, ["right_virtual_mask differs on lanes [3]"]),
    "a match moved": ({"right_to_left": _shift_match}, ["right_to_left differs on lanes [5]"]),
    "int32 matches": ({"left_to_right": lambda m: m.to(torch.int32)}, ["left_to_right torch.int32"]),
}


@pytest.mark.parametrize("case", list(JUDGED))
def test_judge_finds_what_differs(case):
    changes, expected = JUDGED[case]
    cfg = mc.edge_configs(32)["S=32 monotonic=False"]
    _, inp = mc.edge_input(32, "cpu")
    want = tm.run_cone_matching_plain(cfg, inp)
    found = mc.Comparison()
    mc.judge(_wrong(want, **changes), want, found, case)
    assert len(found.faults) == len(expected), found.faults
    for fault, text in zip(found.faults, expected):
        assert text in fault, fault
    assert found.calls == 1 and found.lanes == inp.left_cones.shape[0] and found.virtual_cones > 0


def test_kernel_constants_are_the_cards_float32_operands():
    """The reciprocals of the ellipse radii in float32 (a division by a
    Python scalar runs on the card as a product with one), the angles and
    limits as float32."""
    c = tm.kernel_consts(_cfg(32))
    f32 = np.float32
    assert f32(c.inv_major) == f32(1.0) / f32(7.5) and f32(c.inv_minor) == f32(1.0) / f32(3.0)
    assert f32(c.half_pi) == f32(np.pi / 2) and f32(c.kink) == f32(geo.deg2rad(85.0))
    assert f32(c.max_angle) == f32(np.radians(50.0)) and c.monotonic == 0
    assert tm.kernel_bytes(1, 32) == 1736
