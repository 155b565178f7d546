"""The parameterization kernel (csrc/path_parameterize.cu) against its plain
version on the card, through `tests/param_check.py`, which `chip_smoke.py`
applies too: every parameterization of a trackdrive lap at B = 1, of a
skidpad run, of a batched step at B = 256 and of the initial path, and the
edge lanes at the planner's window and at the dry run's. Needs a CUDA card
and skips without one; imports no JAX, so it runs on the card's machine
with

    python3 -m pytest --noconftest tests/test_torch_param_kernel_card.py
"""

import pytest
import torch

from ft_fsd_path_planning_torch.models import pathing
from tests import param_check as pc


@pytest.mark.parametrize("case", list(pc.drives("cuda")))
def test_kernel_matches_its_plain_version_on_captured_calls(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    launches = pathing.launch_count
    calls = pc.capture(pc.drives("cuda")[case])
    assert calls and pathing.launch_count == launches + len(calls), "the drive did not launch the kernel once a call"
    found = pc.Comparison()
    for i, (cfg, fit, every, p_eval) in enumerate(calls):
        pc.compare(cfg, fit, every, p_eval, found, f"{case} call {i}")
    print(found.summary(case))
    assert not found.faults, found.faults[:20]


@pytest.mark.parametrize("label", list(pc.edge_configs()))
def test_kernel_matches_its_plain_version_on_edge_lanes(label):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    names, fit, every = pc.edge_input("cuda")
    found = pc.Comparison()
    pc.compare(pc.edge_configs()[label], fit, every, 192, found, label)
    print(found.summary(f"edge lanes {label}"))
    assert not found.faults, (found.faults, names)
    assert found.short_lanes == 7
