"""`bench_torch.py` on the CPU at a tiny depth.

`main(["--device", "cpu"])` with BENCH_BATCH=2, BENCH_ITERS=1,
BENCH_LAT_FRAMES=2, BENCH_LARGE_BATCH=2, BENCH_REPLAY_ITERS=1 and
BENCH_REPLAY_FRAMES=12 (the centerline deviation skips the first 10
frames) prints one JSON line: `bench.py`'s keys less the three that come
from XLA's cost analysis and TPU peaks, plus `device` and `power_limit_w`
(null on the CPU), every number finite, the replay's parity against the
reference planner's golden paths under 5 cm on its frames. The bench's
`replay_scan` paths equal a facade replay of the same frames.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import bench_torch
from ft_fsd_path_planning_torch import MissionTypes, PathPlanner
from ft_fsd_path_planning_torch.config import large_map_config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TPU_ONLY_KEYS = {"flops_per_solve", "mfu_pct", "vpu_pct"}
TINY = {
    "BENCH_BATCH": "2", "BENCH_ITERS": "1", "BENCH_LAT_FRAMES": "2",
    "BENCH_LARGE_BATCH": "2", "BENCH_REPLAY_ITERS": "1", "BENCH_REPLAY_FRAMES": "12",
}


def _jax_bench_keys() -> set[str]:
    """The keys `bench.py` prints: the string keys of the dicts its
    functions build and the subscripts they assign (module-level tables
    such as the TPU peaks are not printed)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    keys = set()
    functions = [n for n in tree.body if isinstance(n, ast.FunctionDef)]
    for node in (n for f in functions for n in ast.walk(f)):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys if isinstance(k, ast.Constant) and isinstance(k.value, str)}
        elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store):
            if isinstance(node.slice, ast.Constant):
                keys.add(node.slice.value)
    return keys


@pytest.fixture(scope="module")
def bench_line():
    with pytest.MonkeyPatch.context() as mp:
        for key, value in TINY.items():
            mp.setenv(key, value)
        return bench_torch.run("cpu")


def test_main_prints_one_json_line(capsys, monkeypatch):
    for key, value in {**TINY, "BENCH_LAT_FRAMES": "1"}.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(bench_torch, "CHAIN_MIN", 2)
    bench_torch.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["device"] == "cpu" and line["power_limit_w"] is None


def test_keys_are_the_jax_bench_keys(bench_line):
    line, _ = bench_line
    want = (_jax_bench_keys() - TPU_ONLY_KEYS) | {"device", "power_limit_w"}
    assert "replay_parity_dev_max_m" in want and "latency_b1_device_ms" in want
    assert set(line) == want


def test_values_are_finite_and_parity_holds(bench_line):
    line, paths = bench_line
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert line["unit"] == "solves/s" and "batch=2" in line["metric"]
    for key, value in line.items():
        if key not in ("metric", "unit", "device", "power_limit_w"):
            assert np.isfinite(value) and value > 0, (key, value)
    assert line["vs_baseline"] == pytest.approx(line["value"] / 100.0)
    assert line["replay_parity_dev_max_m"] < 0.05
    assert line["replay_parity_dev_p95_m"] <= line["replay_parity_dev_max_m"]
    assert line["replay_centerline_dev_p95_m"] <= line["replay_centerline_dev_max_m"] < 1.0
    assert paths.shape == (12, 40, 4) and torch.isfinite(paths).all()


def test_replay_paths_equal_a_facade_replay(bench_line):
    _, paths = bench_line
    frames = json.loads((REPO / "ft_fsd_path_planning_tpu/demo/closed_track_session.json").read_text())[:12]
    planner = PathPlanner(MissionTypes.trackdrive, config=large_map_config(), device="cpu")
    want = np.stack([
        planner.calculate_path_in_global_frame(
            [np.asarray(c, float).reshape(-1, 2) for c in f["slam_cones"]],
            np.asarray(f["car_position"]), np.asarray(f["car_direction"]),
        )
        for f in frames
    ])
    np.testing.assert_allclose(paths.numpy(), want, atol=1e-5)


def test_replay_too_short_for_the_centerline_raises(monkeypatch):
    with pytest.raises(ValueError, match="first 10"):
        bench_torch._replay_bench(large_map_config(), 1, torch.device("cpu"), n_frames=5)


def test_refuses_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_torch.run()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_torch.main([])
