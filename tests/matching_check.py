"""The matching kernel (csrc/cone_matching.cu) against its plain version:
the inputs of every matching call of a drive, captured, and edge lanes made
on purpose; both sides run on the same device. `chip_smoke.py` and
`tests/test_torch_matching_card.py` compare on the card; the judgement
(:func:`judge`) and the inputs run on the CPU too, where the tests hold them.

The bar: match indices, masks and virtual masks equal on every lane, cone
coordinates within COORD_TOL. The plain version's squared distances come
from a matrix product, whose last bit may round otherwise than the kernel's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ft_fsd_path_planning_torch.config import MatchingConfig, default_config
from ft_fsd_path_planning_torch.models import matching as tm
from ft_fsd_path_planning_torch.parallel import scenarios

COORD_TOL = 1e-5  # metres
EXACT_FIELDS = ("left_mask", "left_virtual_mask", "right_mask", "right_virtual_mask", "left_to_right", "right_to_left")
CONE_FIELDS = ("left_cones", "right_cones")

#: the benchmark's trackdrive.laps traffic on the trackdrive-fsg layout: 150
#: frames a lap, 0.02 m of jitter on every cone a frame
LAP_SEED, LAP_FRAMES, LAP_JITTER = 3, 150, 0.02


@dataclasses.dataclass
class Comparison:
    """What the comparisons of one case found, over all their lanes."""

    calls: int = 0
    lanes: int = 0
    max_coord: float = 0.0
    virtual_cones: int = 0  # virtual cones in the plain version's outputs
    faults: list = dataclasses.field(default_factory=list)

    def summary(self, label: str) -> str:
        return (
            f"matching kernel vs plain on {label}: {self.calls} calls, {self.lanes} lanes, "
            f"{self.virtual_cones} virtual cones, max |cone - plain| {self.max_coord!r} m, faults {len(self.faults)}"
        )


def judge(got: tm.MatchingOutput, want: tm.MatchingOutput, found: Comparison, label: str) -> None:
    """Add one call's verdict to ``found``: every exact field equal on every
    lane, cones within COORD_TOL (every slot, masked or not)."""
    found.calls += 1
    found.lanes += want.left_mask.shape[0]
    found.virtual_cones += int(want.left_virtual_mask.sum() + want.right_virtual_mask.sum())
    for name in EXACT_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if a.dtype != b.dtype or a.shape != b.shape:
            found.faults.append(f"{label}: {name} {a.dtype} {tuple(a.shape)} != {b.dtype} {tuple(b.shape)}")
            continue
        lanes = torch.nonzero((a != b).flatten(1).any(dim=1)).flatten().tolist()
        if lanes:
            found.faults.append(f"{label}: {name} differs on lanes {lanes[:8]} of {a.shape[0]}")
    for name in CONE_FIELDS:
        diff = (getattr(got, name) - getattr(want, name)).abs()
        worst = float(diff.max()) if diff.numel() else 0.0
        if not worst <= COORD_TOL:  # NaN is a fault too
            found.faults.append(f"{label}: {name} off by {worst!r} m")
        found.max_coord = max(found.max_coord, worst) if worst == worst else found.max_coord


def compare(cfg, inp: tm.MatchingInput, found: Comparison, label: str) -> None:
    """Run the kernel and the plain version on ``inp`` (on the card) and
    judge: the kernel must have launched once."""
    want = tm.run_cone_matching_plain(cfg, inp)
    launches = tm.launch_count
    got = tm.run_cone_matching_cuda(cfg, inp)
    torch.cuda.synchronize()
    if tm.launch_count != launches + 1:
        found.faults.append(f"{label}: the kernel launched {tm.launch_count - launches} times")
    judge(got, want, found, label)


def capture(run) -> list[tuple]:
    """Call ``run()`` and keep (cfg, input) of every matching call it makes."""
    calls = []
    original = tm.run_cone_matching

    def recording(cfg, inp):
        calls.append((cfg, tm.MatchingInput(*(t.clone() for t in inp))))
        return original(cfg, inp)

    tm.run_cone_matching = recording
    try:
        run()
    finally:
        tm.run_cone_matching = original
    return calls


def lap_frames() -> list[tuple]:
    """Every frame of one lap of the benchmark's trackdrive.laps traffic:
    the whole map of the trackdrive-fsg layout, fresh jitter a frame."""
    left, right, unknown, cl, tangent = scenarios.closed_track_scenario(LAP_SEED)
    n = len(cl)
    frames = []
    for i in range(LAP_FRAMES):
        rng = np.random.default_rng([LAP_SEED, i])
        jit = lambda a: np.round(a + rng.normal(0.0, LAP_JITTER, a.shape), 4)  # noqa: E731
        j = (i * n) // LAP_FRAMES
        frames.append((scenarios._cone_lists(jit(unknown), jit(left), jit(right)), cl[j].copy(), tangent[j].copy()))
    return frames


def _arc(n: int, offset: float, start: float = 0.0, radius: float = 30.0, step: float = 3.5) -> np.ndarray:
    """``n`` cones 3.5 m apart along a circle of ``radius``, ``offset``
    metres to its left (negative: right), from arc length ``start``."""
    t = (start + step * np.arange(n)) / radius
    r = radius - offset
    return np.stack([r * np.sin(t), radius - r * np.cos(t)], axis=1)


#: edge lanes: (name, left cones, right cones), each side in driving order
def edge_lanes() -> list[tuple[str, np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(16)
    straight = lambda n, y: np.stack([3.5 * np.arange(n), np.full(n, y)], axis=1)  # noqa: E731
    lanes = [
        ("left side empty", np.zeros((0, 2)), straight(5, -1.5)),
        ("one cone a side", straight(1, 1.5), straight(1, -1.5)),
        ("two cones a side", straight(2, 1.5), straight(2, -1.5)),
        ("one and two cones", straight(1, 1.5), straight(2, -1.5)),
        ("discard guard, left 3 right 10", straight(3, 1.5), straight(10, -1.5)),
        ("discard guard, left 9 right 4", straight(9, 1.5), straight(4, -1.5)),
        ("no virtual cones: straight pairs", straight(12, 1.5), straight(12, -1.5)),
        ("no virtual cones: arc pairs", _arc(12, 1.5), _arc(12, -1.5)),
        # 24 cones after the merge: more than a side of 16 slots holds
        ("every cone unmatched", straight(12, 60.0), straight(12, -60.0)),
        ("three missing on the right", _arc(12, 1.5), _arc(12, -1.5)[[0, 1, 2, 6, 7, 8, 9, 10, 11]]),
        ("right side offset by half a spacing", _arc(10, 1.5), _arc(10, -1.5, start=1.75)),
        ("hairpin", _arc(12, 1.5, radius=6.0, step=2.0), _arc(12, -1.5, radius=6.0, step=2.0)),
        # matches that fall back along the side: what monotonic matching drops
        ("two right cones swapped", straight(10, 1.5), straight(10, -1.5)[[0, 1, 2, 3, 5, 4, 6, 7, 8, 9]]),
    ]
    for k in range(4):  # noisy arcs with cones dropped at random on both sides
        left = _arc(12, 1.5, radius=20.0 + 10 * k) + rng.normal(0.0, 0.1, (12, 2))
        right = _arc(12, -1.5, radius=20.0 + 10 * k) + rng.normal(0.0, 0.1, (12, 2))
        lanes.append((f"noisy arc {k}", left[rng.random(12) > 0.25], right[rng.random(12) > 0.25]))
    return lanes


def edge_input(s: int, device, full: bool = False) -> tuple[list[str], tm.MatchingInput]:
    """The edge lanes as one batch of sides of ``s`` slots, the car at the
    origin heading along +x; masked-out slots hold seeded noise, as a
    sorter's padding may. ``full`` adds a lane whose sides fill all ``s``
    slots."""
    lanes = edge_lanes()
    if full:
        lanes.append(("full sides", _arc(s, 1.5, radius=200.0), _arc(s, -1.5, radius=200.0)))
    rng = np.random.default_rng(s)
    b = len(lanes)
    cones = rng.normal(0.0, 20.0, (2, b, s, 2)).astype(np.float32)
    masks = np.zeros((2, b, s), bool)
    for i, (_, left, right) in enumerate(lanes):
        for k, side in enumerate((left, right)):
            side = side[:s]
            cones[k, i, : len(side)] = side
            masks[k, i, : len(side)] = True
    t = lambda a: torch.tensor(a, device=device)  # noqa: E731
    position = torch.zeros((b, 2), dtype=torch.float32, device=device)
    direction = torch.tensor([[1.0, 0.0]] * b, dtype=torch.float32, device=device)
    inp = tm.MatchingInput(t(cones[0]), t(masks[0]), t(cones[1]), t(masks[1]), position, direction)
    return [name for name, _, _ in lanes], inp


def edge_configs(s: int) -> dict:
    """The default configuration at side length ``s``, with monotonic
    matches off (the default) and on."""
    base = default_config(n_cones=128)
    shapes = dataclasses.replace(base.shapes, side_len=s)
    return {
        f"S={s} monotonic={mono}": dataclasses.replace(
            base, shapes=shapes, matching=MatchingConfig(matches_should_be_monotonic=mono)
        )
        for mono in (False, True)
    }
