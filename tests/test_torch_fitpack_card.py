"""The part-2 kernel (csrc/fitpack_part2.cu) against its plain version on
the card, lane by lane, through the comparison and the limits of
tests/part2_check.py that chip_smoke.py applies too. Needs a CUDA card and
skips without one; imports no JAX, so it runs on the card's machine with

    python3 -m pytest --noconftest tests/test_torch_fitpack_card.py
"""

import numpy as np
import pytest
import torch

from ft_fsd_path_planning_torch import PathPlanner
from ft_fsd_path_planning_torch.config import default_config
from ft_fsd_path_planning_torch.ops import fitpack as tfp
from ft_fsd_path_planning_torch.parallel import batch as tbatch
from ft_fsd_path_planning_torch.parallel import scenarios
from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes
from tests import part2_check
from tests.torch_parity import seeded_traces

#: skidpad session frames whose fits are batched: the entry, both circles, the exit
SKIDPAD_FRAMES = (0, 70, 140, 210, 280, 350, 420, 540)


def _skidpad(s: float) -> list[tuple]:
    """Part 2 of the fits with smoothing ``s`` that a new skidpad planner
    makes on each of SKIDPAD_FRAMES, batched: B = 8 (s = 0.01 on 256
    sites, s = 0.2 on 512)."""
    frames = scenarios.skidpad_session()
    rows = []
    original = tfp.fitpack_fit

    def recording(points, mask, smoothing):
        if np.float32(smoothing) == np.float32(s):
            rows.append((points, mask))
        return original(points, mask, smoothing)

    for k in SKIDPAD_FRAMES:
        planner = PathPlanner(MissionTypes.skidpad, device="cuda")
        tfp.fitpack_fit = recording
        try:
            planner.calculate_path_in_global_frame(*frames[k])
        finally:
            tfp.fitpack_fit = original
    pts, mask = torch.cat([p for p, _ in rows]), torch.cat([m for _, m in rows])
    return part2_check.capture(lambda: tfp.fitpack_fit(pts, mask, s))


def _batched_step() -> list[tuple]:
    """The three part 2s of a trackdrive batched_step at B = 256."""
    cfg = default_config(n_cones=128)
    frames = scenarios.make_frame_batch(cfg, 256, seed=1, device="cuda")
    state = tbatch.make_batch_state(cfg, 256, "cuda")
    return part2_check.capture(lambda: tbatch.batched_step(cfg, state, frames))


def _acceleration() -> list[tuple]:
    """Part 2 of the acceleration session's frames 0, 20, 22 and 37 through
    one planner: fits of 256, 704 and 1,024 sites, and the hairpin, where a
    float32 factorisation can break down and the p-iteration retries."""
    frames = scenarios.mission_sessions()["acceleration"][1]
    cfg = default_config(MissionTypes.acceleration, n_cones=128)
    planner = PathPlanner(MissionTypes.acceleration, config=cfg, device="cuda")
    return part2_check.capture(lambda: [planner.calculate_path_in_global_frame(*frames[i]) for i in (0, 20, 22, 37)])


def _acceleration_fit() -> tuple:
    """The part-2 call of acceleration frame 0's fit of 704 sites."""
    frames = scenarios.mission_sessions()["acceleration"][1]
    cfg = default_config(MissionTypes.acceleration, n_cones=128)
    planner = PathPlanner(MissionTypes.acceleration, config=cfg, device="cuda")
    calls = part2_check.capture(lambda: planner.calculate_path_in_global_frame(*frames[0]))
    return next(a for a in calls if a[2].shape[1] == 704)


def _clustered() -> list[tuple]:
    """acceleration frame 0's fit of 704 sites, its middle knot moved towards
    its neighbour lane by lane (B = 256): small-p trials break down."""
    return [part2_check.clustered_knots(_acceleration_fit())]


def _broken_trials() -> list[tuple]:
    """The lanes of that clustered set whose plain trial breaks down."""
    return [part2_check.broken_trials(_acceleration_fit())]


def _seeded(seed: int, s: float, m: int, live, bsz: int) -> list[tuple]:
    pts, mask = seeded_traces(seed, bsz, m, 0.05, live)
    return part2_check.capture(lambda: tfp.fitpack_fit(torch.tensor(pts, device="cuda"), torch.tensor(mask, device="cuda"), s))


CASES = {
    "skidpad s=0.01 (8, 256)": lambda: _skidpad(0.01),
    "skidpad s=0.2 (8, 512)": lambda: _skidpad(0.2),
    "trackdrive batched_step B=256": _batched_step,
    "acceleration frames 0, 20, 22, 37 B=1": _acceleration,
    "acceleration fit with clustered knots (256, 704)": _clustered,
    "clustered lanes whose trial breaks down (704 sites)": _broken_trials,
    # a step of branch 2 that the bracket pulls back inside
    "trackdrive witness (1, 64)": lambda: [part2_check.witness("cuda")],
    # acceleration's dense samples: 1,024 sites, over 48 KB of shared memory
    "seeded traces (8, 1024)": lambda: _seeded(2, 0.2, 1024, (40, 700), 8),
    # long noisy traces: many lanes stop unconverged on the knot budget
    "seeded traces (256, 512)": lambda: _seeded(3, 0.2, 512, None, 256),
}


@pytest.mark.parametrize("case", list(CASES))
def test_part2_kernel_matches_its_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    calls = CASES[case]()
    assert calls
    found = part2_check.Part2Comparison()
    for args in calls:
        launches = tfp.part2_launch_count
        part2_check.compare(args, found, case)
        assert tfp.part2_launch_count == launches + 1
    print(found.summary(), *found.differ, sep="\n")
    assert not found.faults, found.faults
    assert found.converged > 0
    if case.startswith(("acceleration fit with clustered knots", "clustered lanes")):
        assert found.retried_same_trips > 0
    if case.startswith("clustered lanes"):
        assert found.retried == found.lanes
    if case.startswith("trackdrive witness"):
        assert found.converged == found.lanes == 1


def test_witness_fit_on_the_card_is_scipys():
    """The witness fit on the card converges (|fp - s| <= acc) and lies
    within 1 mm of SciPy's splprep on the same points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from scipy.interpolate import splev

    points, mask = part2_check.witness_fit_inputs("cuda")
    fit = tfp.fitpack_fit(points, mask, part2_check.WITNESS_S)
    tck, u, fp_ref, _ = part2_check.witness_scipy()
    grid = np.linspace(0.0, u[-1], 400)
    ours = tfp.fitpack_eval(fit, torch.tensor(grid, dtype=torch.float32, device="cuda")[None])[0].cpu().numpy()
    fp = float(part2_check.fit_fp(fit, points, mask)[0])
    assert abs(fp - part2_check.WITNESS_S) <= tfp.TOL * part2_check.WITNESS_S, (fp, fp_ref)
    assert np.linalg.norm(ours - np.stack(splev(grid, tck), axis=1), axis=1).max() < 1e-3
