"""The port's scenario generators and timing utilities against the JAX
package's counterparts.

* `closed_track_scenario` and `closed_track_frames` are numpy generators:
  the same seed and arguments must give the JAX package's arrays bit for bit
  (the port keeps its own copy and imports nothing of the JAX package).
* `Timer` on the CPU has the JAX package's Timer's interface: intervals
  accumulate per name across instances, the report has the same form, and
  `reset` clears them. On a CUDA device it reads CUDA events (checked on the
  card only).
* `device_trace` writes a Chrome trace of the block it wraps.
"""

import json
import re
import time

import numpy as np
import pytest
import torch

from ft_fsd_path_planning_tpu.parallel import scenarios as jscen
from ft_fsd_path_planning_tpu.utils import timer as jtimer
from ft_fsd_path_planning_torch.parallel import scenarios as tscen
from ft_fsd_path_planning_torch.utils import timer as ttimer

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"seed": 3}, {"seed": 1, "base_radius": 42.0, "spacing": 3.2}, {"seed": 2, "half_width": 2.0, "n_unknown": 0}],
    ids=["defaults", "seed 3", "large loop", "wide, no unknown cones"],
)
def test_closed_track_scenario_equals_jax(kwargs):
    ours, theirs = tscen.closed_track_scenario(**kwargs), jscen.closed_track_scenario(**kwargs)
    assert len(ours) == len(theirs) == 5
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    left, right, unknown, centerline, tangent = ours
    assert len(left) == len(right) == len(centerline) > 40 and len(unknown) == kwargs.get("n_unknown", 6)
    np.testing.assert_allclose(np.linalg.norm(tangent, axis=1), 1.0, atol=1e-12)


@pytest.mark.parametrize("kwargs", [{}, {"seed": 2, "n_frames": 3, "base_radius": 42.0, "spacing": 3.2}], ids=["defaults", "3 frames"])
def test_closed_track_frames_equal_jax(kwargs):
    ours, theirs = tscen.closed_track_frames(**kwargs), jscen.closed_track_frames(**kwargs)
    assert len(ours) == len(theirs) == kwargs.get("n_frames", 8)
    for (cones_o, pos_o, dir_o), (cones_t, pos_t, dir_t) in zip(ours, theirs):
        assert len(cones_o) == len(cones_t) == 5
        for a, b in zip(cones_o, cones_t):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pos_o, pos_t)
        np.testing.assert_array_equal(dir_o, dir_t)


def test_closed_track_frames_drive_the_port():
    """A whole-map frame of the closed track goes through the port's planner
    and gives a path that starts at the car."""
    from ft_fsd_path_planning_torch import MissionTypes, PathPlanner
    from ft_fsd_path_planning_torch.config import default_config

    cones, pos, direction = tscen.closed_track_frames(seed=0, n_frames=2)[1]
    planner = PathPlanner(MissionTypes.trackdrive, config=default_config(MissionTypes.trackdrive, n_cones=256), device="cpu")
    path = planner.calculate_path_in_global_frame(cones, pos, direction)
    assert path.shape == (40, 4) and np.isfinite(path).all()
    assert np.linalg.norm(path[0, 1:3] - pos) < 1.0


def _timed(module, name: str, naps: tuple[float, ...]):
    module.Timer.reset()
    timers = []
    for nap in naps:
        with module.Timer(name, noprint=True) as timer:
            time.sleep(nap)
        timers.append(timer)
    return timers


def test_timer_on_the_cpu_behaves_as_the_jax_timer(capsys):
    naps = (0.02, 0.01, 0.03)
    number = r"\d+\.\d+"
    form = re.compile(rf"^fit: last {number} ms \| n=3 mean {number} ms cum {number} ms$")
    for module in (ttimer, jtimer):
        timers = _timed(module, "fit", naps)
        last = timers[-1]
        assert len(last.intervals) == 3  # intervals accumulate per name across instances
        for interval, nap in zip(last.intervals, naps):
            assert nap <= interval < nap + 0.05
        assert last.interval == last.intervals[-1]
        assert last.cum_time == pytest.approx(sum(last.intervals))
        assert last.mean_time == pytest.approx(last.cum_time / 3)
        assert form.match(last.report()), last.report()
        assert module.Timer("other", noprint=True).intervals == [] and module.Timer("other").mean_time == 0.0
        module.Timer.reset()
        assert module.Timer("fit").intervals == []
    assert capsys.readouterr().out == ""
    with ttimer.Timer("printed", device="cpu"):
        pass
    assert capsys.readouterr().out.startswith("printed: last ")
    ttimer.Timer.reset()


def test_timer_defaults_to_the_host_clock():
    assert ttimer.Timer("t").device == torch.device("cpu")
    assert ttimer.Timer("t", device=torch.device("cpu"))._events is None


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with ttimer.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key or "matmul" in e.key for e in prof.key_averages())
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
