"""The port's profile tools on the CPU at a small size (B = 2, 32 cones).

On the CPU there are no kernels and no host-device syncs: the unit of
`profile_device` is the torch call, and syncs are reported absent (null),
never 0. Checked: the per-line counts add up to the step's total, and so do
the stages'; every torch call of the step is credited to a line of the
package and a pipeline stage; the three FITPACK fit sites of
`models/pathing.py` appear with the same number of calls each (the fits
run the same masked loops); `profile_pathing` reports the centerline fit,
the refit in `_parameterize_path` and the final refit once each, and the
fits of the initial path apart.
"""

import json

import pytest
import torch

from ft_fsd_path_planning_torch import profile_device, profile_pathing

torch.set_num_threads(1)

SMALL = ["--device", "cpu", "--batch", "2", "--n-cones", "32"]


@pytest.fixture(scope="module")
def device_report(tmp_path_factory):
    out = tmp_path_factory.mktemp("profile") / "profile_device.json"
    printed = profile_device.main([*SMALL, "--top", "8", "--out", str(out)])
    return printed, json.loads(out.read_text())


def test_profile_device_lines_and_stages_add_up(device_report):
    printed, saved = device_report
    assert saved["unit"] == "torch calls" and saved["device"] == "cpu"
    assert saved["total"] > 1000 and saved["unowned"] == 0
    assert sum(v["torch calls"] for v in saved["all_lines"].values()) == saved["total"]
    assert sum(v["torch calls"] for v in saved["by_stage"].values()) == saved["total"]
    assert {"sorting", "matching", "pathing"} <= set(saved["by_stage"])
    assert all(line.split(":")[0].endswith(".py") for line in saved["all_lines"])
    assert len(printed["top_lines"]) == 8 and "all_lines" in printed


def test_profile_device_reports_syncs_absent_on_the_cpu(device_report):
    _, saved = device_report
    assert saved["syncs"] is None and saved["sync_lines"] is None and saved["fitpack_sync_lines"] is None
    assert profile_device.attribute_syncs(lambda: None, torch.device("cpu")) is None


def test_profile_device_credits_the_three_fit_sites(device_report):
    _, saved = device_report
    sites = saved["by_fit_site"]
    assert len(sites) == 3, sites
    assert any("_fit_and_densify" in s and "run_path_calculation" in s for s in sites)
    assert any("_parameterize_path" in s for s in sites)
    assert any(s.startswith("models/pathing.py") and s.endswith("run_path_calculation") for s in sites)
    assert len({v["torch calls"] for v in sites.values()}) == 1
    assert all(line["line"].startswith("ops/fitpack.py") for line in saved["fitpack_lines"])
    assert all(" <- " in c["call"] and c["call"].startswith("ops/fitpack.py") for c in saved["fitpack_calls"])


def test_site_helpers():
    frames = [
        ("ops/fitpack.py", 300, "_loop"), ("ops/fitpack.py", 530, "fitpack_fit"),
        ("models/pathing.py", 105, "_fit_and_densify"), ("models/pathing.py", 474, "run_path_calculation"),
        ("models/planner.py", 200, "_planner_step_impl"),
    ]
    site = profile_device.Site(frames)
    assert site.line == "ops/fitpack.py:300 _loop" and site.stage == "pathing"
    assert site.call == "ops/fitpack.py:300 _loop <- ops/fitpack.py:530 fitpack_fit"
    assert site.fit == "models/pathing.py:105 _fit_and_densify <- models/pathing.py:474 run_path_calculation"
    assert profile_device.stage_of([("models/planner.py", 1, "f")]) == "planner-other"
    assert profile_device.Site([]).stage == "(outside the pipeline)"


def test_profile_pathing_reports_each_fit(capsys):
    out = profile_pathing.main([*SMALL, "--reps", "1"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(json.dumps(out))
    sites = [f["site"] for f in out["fits"]]
    for name in profile_pathing.SITES.values():
        assert sites.count(name) == 1, (name, sites)
    initial = [s for s in sites if s.startswith("initial path, once")]
    assert len(initial) == 2 and len(sites) == 5
    for fit in out["fits"]:
        assert fit["torch calls"] > 100 and fit["syncs"] is None and fit["ms"] > 0
        assert fit["lines"].startswith("models/pathing.py:")


def test_entry_points_refuse_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_device.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_pathing.main([])
