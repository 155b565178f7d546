"""The matching kernel (csrc/cone_matching.cu) against its plain version on
the card, through `tests/matching_check.py`, which `chip_smoke.py` applies
too: every matching call of a trackdrive lap at B = 1, of a batched step at
B = 256 (S = 32) and at the dry run's budget (S = 16), and the edge lanes
at S = 16, 32, 48 and 64 with monotonic matching off and on. Needs a CUDA
card and skips without one; imports no JAX, so it runs on the card's
machine with

    python3 -m pytest --noconftest tests/test_torch_matching_card.py
"""

import pytest
import torch

from ft_fsd_path_planning_torch import PathPlanner
from ft_fsd_path_planning_torch.config import default_config
from ft_fsd_path_planning_torch.models import matching as tm
from ft_fsd_path_planning_torch.parallel import batch as tbatch
from ft_fsd_path_planning_torch.parallel import dryrun, scenarios
from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes
from tests import matching_check as mc


def _lap() -> list[tuple]:
    """Every frame of a lap of trackdrive.laps' traffic through one planner
    at n_cones 256: B = 1, S = 32."""
    planner = PathPlanner(MissionTypes.trackdrive, config=default_config(n_cones=256), device="cuda")
    frames = mc.lap_frames()
    return mc.capture(lambda: [planner.calculate_path_in_global_frame(*f) for f in frames])


def _batched_step(cfg, b: int, seed: int) -> list[tuple]:
    frames = scenarios.make_frame_batch(cfg, b, seed=seed, device="cuda")
    state = tbatch.make_batch_state(cfg, b, "cuda")
    return mc.capture(lambda: tbatch.batched_step(cfg, state, frames))


CAPTURED = {
    "trackdrive lap, 150 frames B=1 S=32": _lap,
    "batched_step B=256 S=32": lambda: _batched_step(default_config(n_cones=128), 256, 1),
    "batched_step B=64 S=16 (dry run's budget)": lambda: _batched_step(dryrun.tiny_config(), 64, 2),
}


@pytest.mark.parametrize("case", list(CAPTURED))
def test_kernel_matches_its_plain_version_on_captured_calls(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    launches = tm.launch_count
    calls = CAPTURED[case]()
    assert calls and tm.launch_count == launches + len(calls), "the drive did not launch the kernel once a call"
    found = mc.Comparison()
    for i, (cfg, inp) in enumerate(calls):
        mc.compare(cfg, inp, found, f"{case} call {i}")
    print(found.summary(case))
    assert not found.faults, found.faults[:20]
    assert found.virtual_cones > 0


@pytest.mark.parametrize("s", [16, 32, 48, 64])
def test_kernel_matches_its_plain_version_on_edge_lanes(s):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    names, inp = mc.edge_input(s, "cuda", full=True)
    for label, cfg in mc.edge_configs(s).items():
        found = mc.Comparison()
        mc.compare(cfg, inp, found, label)
        print(found.summary(f"edge lanes {label}"))
        assert not found.faults, (found.faults, names)
