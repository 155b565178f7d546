"""A tiny run of each loop on the CPU: the harness drives the program, the
check passes, and the process loads neither JAX nor the JAX package."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

DRYRUN = Path(__file__).with_name("dryrun.py")
SMALL = {
    "trackdrive.online": {},
    "trackdrive.sweep": {"batch": 3, "check_sample": 6, "warmup_steps": 1},
    "skidpad.online": {},
}


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_dry_run_is_correct_and_loads_no_jax(workload):
    proc = subprocess.run(
        [sys.executable, str(DRYRUN), workload, str(2**31 + 5), "1.5", json.dumps(SMALL[workload])],
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == []
    result = out["result"]
    assert result["correct"] is True, result["check"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "check"


def test_run_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, str(DRYRUN.parents[1] / "run.py"), "--workload", "trackdrive.online",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
    )
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this test is for a machine without one")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_traced_frames_do_not_depend_on_speed(workload):
    """A traced run drives a fixed number of frames on before it traces, and
    records only the traced ones."""
    from harness import cell as cells
    from trackdrive_cells import load

    cell = load(workload)
    cell.traffic.update(SMALL[workload], trace_after_frames=2, trace_after_steps=1, trace_frames=2,
                        trace_steps=1, stage_frames=1, stage_steps=1, warmup_frames=1)
    loop = cells.loop_module(cell).Loop(cell, 7, cells.track_module(cell), "cpu")
    loop.setup()
    loop.to_traced()
    assert loop.traced_units() == cell.traffic[f"trace_{loop.unit}s"]
    loop.staged_units()
    first = min(k if isinstance(k, int) else k[0] for k, _ in loop.to_check(np.random.default_rng(0)))
    assert first == loop_start(loop) + (2 if loop.unit == "frame" else 1)


def loop_start(loop):
    if loop.unit == "step":
        return loop.traffic["warmup_steps"]
    # skidpad relocalizes on its first frame, so set-up adds no frame to it
    return loop.drive.start(np.random.default_rng([loop.seed, 0])) + loop.traffic["warmup_frames"]
