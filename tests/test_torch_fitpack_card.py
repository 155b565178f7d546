"""The fit kernel (csrc/fitpack_part2.cu) against its plain version on the
card, lane by lane, through the comparison and the limits of
tests/part2_check.py that chip_smoke.py applies too: whole fits, parts 1
and 2 from iteration 0. Needs a CUDA card and skips without one; imports
no JAX, so it runs on the card's machine with

    python3 -m pytest --noconftest tests/test_torch_fitpack_card.py
"""

import numpy as np
import pytest
import torch

from ft_fsd_path_planning_torch import PathPlanner
from ft_fsd_path_planning_torch.config import default_config
from ft_fsd_path_planning_torch.models import pathing
from ft_fsd_path_planning_torch.ops import fitpack as tfp
from ft_fsd_path_planning_torch.parallel import batch as tbatch
from ft_fsd_path_planning_torch.parallel import scenarios
from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes
from tests import part2_check
from tests.torch_parity import seeded_traces

#: skidpad session frames whose fits are batched: the entry, both circles, the exit
SKIDPAD_FRAMES = (0, 70, 140, 210, 280, 350, 420, 540)


def _skidpad(s: float) -> list[tuple]:
    """The fits with smoothing ``s`` that a new skidpad planner makes on
    each of SKIDPAD_FRAMES, batched: B = 8 (s = 0.01 on 256 sites, s = 0.2
    on 512)."""
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
    return [part2_check.fit_inputs(pts, mask, s)]


def _trackdrive_lap() -> list[tuple]:
    """Every fit of the first 40 frames of a trackdrive lap through one
    planner at n_cones 256, three a frame."""
    planner = PathPlanner(MissionTypes.trackdrive, config=default_config(n_cones=256), device="cuda")
    frames = scenarios.closed_track_frames(seed=1, n_frames=40)
    return part2_check.capture_fits(lambda: [planner.calculate_path_in_global_frame(*f) for f in frames])


def _batched_step() -> list[tuple]:
    """The three fits of a trackdrive batched_step at B = 256."""
    cfg = default_config(n_cones=128)
    frames = scenarios.make_frame_batch(cfg, 256, seed=1, device="cuda")
    state = tbatch.make_batch_state(cfg, 256, "cuda")
    return part2_check.capture_fits(lambda: tbatch.batched_step(cfg, state, frames))


def _initial_path() -> list[tuple]:
    """The planner's initial path: a fit of the almost-straight chord on
    the 384-row global window, densified to 768 samples, and the refit of
    its parameterisation."""
    cfg = default_config(n_cones=128)
    return part2_check.capture_fits(lambda: pathing.initial_path_state(cfg, 1, torch.device("cuda")))


def _acceleration() -> list[tuple]:
    """The fits of the acceleration session's frames 0, 20, 22 and 37
    through one planner: 256, 704 and 1,024 sites, and the hairpin."""
    frames = scenarios.mission_sessions()["acceleration"][1]
    cfg = default_config(MissionTypes.acceleration, n_cones=128)
    planner = PathPlanner(MissionTypes.acceleration, config=cfg, device="cuda")
    return part2_check.capture_fits(lambda: [planner.calculate_path_in_global_frame(*frames[i]) for i in (0, 20, 22, 37)])


def _hairpin_copies() -> list[tuple]:
    """256 noisy copies of the acceleration hairpin's 704-site fit, on
    which part 2's small-p trials break down and retry."""
    frames = scenarios.mission_sessions()["acceleration"][1][: part2_check.HAIRPIN_FRAME + 1]
    cfg = default_config(MissionTypes.acceleration, n_cones=128)
    planner = PathPlanner(MissionTypes.acceleration, config=cfg, device="cuda")
    fits = part2_check.capture_fits(lambda: [planner.calculate_path_in_global_frame(*f) for f in frames])
    return [part2_check.hairpin_copies([a for a in fits if a[2].shape[1] == 704][-1])]


def _seeded(seed: int, s: float, m: int, live, bsz: int) -> list[tuple]:
    pts, mask = seeded_traces(seed, bsz, m, 0.05, live)
    return [part2_check.fit_inputs(torch.tensor(pts, device="cuda"), torch.tensor(mask, device="cuda"), s)]


#: whole fits from their iteration 0: kernel against the plain version
FIT_CASES = {
    "skidpad s=0.01 (8, 256)": lambda: _skidpad(0.01),
    "skidpad s=0.2 (8, 512)": lambda: _skidpad(0.2),
    "trackdrive lap, 40 frames B=1": _trackdrive_lap,
    "trackdrive batched_step B=256": _batched_step,
    "initial path (1, 384)": _initial_path,
    "acceleration frames 0, 20, 22, 37 B=1": _acceleration,
    # the kernel's step after a float32 breakdown, through the fit entry
    "acceleration hairpin copies (256, 704)": _hairpin_copies,
    # a step of branch 2 that the bracket pulls back inside
    "trackdrive witness (1, 64)": lambda: [part2_check.fit_inputs(*part2_check.witness_fit_inputs("cuda"), part2_check.WITNESS_S)],
    # acceleration's dense samples: 1,024 sites, over 48 KB of shared memory
    "seeded traces (8, 1024)": lambda: _seeded(2, 0.2, 1024, (40, 700), 8),
    # long noisy traces, tiny lanes among them: many lanes stop on the knot budget
    "seeded traces (256, 512)": lambda: _seeded(3, 0.2, 512, None, 256),
}


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_fit_kernel_matches_its_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    calls = FIT_CASES[case]()
    assert calls
    found = part2_check.FitComparison()
    for args in calls:
        launches = tfp.part2_launch_count
        part2_check.compare_fits(args, found, case)
        assert tfp.part2_launch_count == launches + 1
    print(found.summary(), *found.near_ties, *found.differ, sep="\n")
    assert not found.faults, found.faults
    assert found.same_knots > 0
    if case.startswith("initial path"):
        # two fits that end at iteration 0's least-squares spline
        assert calls[0][2].shape[1] == 384 and found.lsq == found.lanes
    else:
        assert found.converged > 0
    if case.startswith("acceleration hairpin"):
        # the kernel's step after a breakdown, matched trip for trip
        assert found.retried_same_trips > 0
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
