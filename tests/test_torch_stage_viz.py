"""The port's stage viewer against the arrays the JAX package's
`demo/stage_viz.py::render` draws, and the drawing itself, on the CPU.

For two scenarios the port's `stage_data` is held against what `render`
computes before it draws (the same calls: the facade with intermediate
results, then per side `select_starting_cones`, `build_adjacency`,
`sort_one_side` and `polyline_self_intersections` on the flattened cones):
the adjacency edges, the pool's configs, validity, winner and
self-intersection counts and the match indices equal; the costs to 1e-4
(float32 sums in another order); the path laterally within 1 cm
(`tests/torch_parity.py`). `draw` writes a PNG with the Agg backend. The
port's notebook runs its code cells in order on the CPU and plans the
JAX notebook's paths, within 1 cm.
"""

from pathlib import Path

import nbformat
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ft_fsd_path_planning_tpu import MissionTypes as JMissionTypes
from ft_fsd_path_planning_tpu import PathPlanner as JPathPlanner
from ft_fsd_path_planning_tpu.demo.scenarios import ALL_SCENARIOS as JSCENARIOS
from ft_fsd_path_planning_tpu.models import sorting as jsorting
from ft_fsd_path_planning_tpu.models.facade import flatten_cones_by_type as jflatten
from ft_fsd_path_planning_tpu.ops import geometry as jgeo
from ft_fsd_path_planning_torch.demo import stage_viz
from ft_fsd_path_planning_torch.demo.scenarios import ALL_SCENARIOS
from ft_fsd_path_planning_torch.utils.cone_types import ConeTypes
from tests.torch_parity import path_parity_deviation

torch.set_num_threads(1)

NAMES = ("hairpin", "colorless_straight")
REPO = Path(__file__).resolve().parent.parent


def _jax_render_arrays(name: str) -> dict:
    """What `render` computes for ``name`` before drawing."""
    cones, pos, direction = JSCENARIOS[name]()
    planner = JPathPlanner(JMissionTypes.trackdrive)
    path, sorted_l, sorted_r, left_v, right_v, l2r, r2l = planner.calculate_path_in_global_frame(
        cones, pos, direction, return_intermediate_results=True
    )
    cfg = planner.cfg
    pts, mask = jflatten(cones, cfg.shapes.n_cones)
    pts_j, mask_j = jnp.asarray(pts), jnp.asarray(mask)
    pos_j, dir_j = jnp.asarray(pos, jnp.float32), jnp.asarray(direction, jnp.float32)
    out = {"path": path, "l2r": l2r, "r2l": r2l, "left_v": left_v, "right_v": right_v,
           "sorted_left": sorted_l, "sorted_right": sorted_r, "adjacency": {}, "beam": {}}
    for ct in stage_viz.SIDES:
        prefix, _ = jsorting.select_starting_cones(cfg.sorting, pts_j, mask_j, int(ct), pos_j, dir_j)
        adj, _, _ = jsorting.build_adjacency(cfg.sorting, pts_j, mask_j, int(ct), prefix[0])
        out["adjacency"][ct] = np.argwhere(np.triu(np.asarray(adj)))
        res = jsorting.sort_one_side(cfg, pts_j, mask_j, int(ct), pos_j, dir_j)
        configs, valid = np.asarray(res.configs), np.asarray(res.valid)
        xy = pts[:, :2]
        crossings = jgeo.polyline_self_intersections(
            jnp.asarray(xy[np.clip(configs, 0, len(xy) - 1)], jnp.float32),
            jnp.asarray((configs >= 0) & valid[:, None]),
        )
        out["beam"][ct] = {"configs": configs, "valid": valid, "costs": np.asarray(res.costs),
                           "best": np.asarray(res.best), "self_crossings": np.asarray(crossings)}
    return out


@pytest.fixture(scope="module", params=NAMES)
def both(request):
    return request.param, stage_viz.stage_data(request.param, device="cpu"), _jax_render_arrays(request.param)


def test_stage_data_matches_what_render_draws(both):
    name, ours, theirs = both
    assert ours["name"] == name
    for ct in stage_viz.SIDES:
        np.testing.assert_array_equal(ours["adjacency"][ct], theirs["adjacency"][ct])
        assert len(ours["adjacency"][ct]) > 3
        mine, ref = ours["beam"][ct], theirs["beam"][ct]
        for key in ("configs", "valid", "best", "self_crossings"):
            np.testing.assert_array_equal(mine[key], ref[key], err_msg=f"{ConeTypes(ct).name} {key}")
        finite = np.isfinite(ref["costs"])
        np.testing.assert_array_equal(np.isfinite(mine["costs"]), finite)
        np.testing.assert_allclose(mine["costs"][finite], ref["costs"][finite], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ours["matches"]["left_to_right"], theirs["l2r"])
    np.testing.assert_array_equal(ours["matches"]["right_to_left"], theirs["r2l"])
    np.testing.assert_allclose(ours["matches"]["left"], theirs["left_v"], atol=1e-4)
    np.testing.assert_allclose(ours["sorted_right"], theirs["sorted_right"], atol=1e-4)
    assert ours["path"].shape == (40, 4) and np.isfinite(ours["path"]).all()
    assert path_parity_deviation(theirs["path"], ours["path"]) < 0.01


def test_stage_data_inputs_are_the_scenario(both):
    name, ours, _ = both
    cones, pos, direction = ALL_SCENARIOS[name]()
    for got, want in zip(ours["cones"], cones):
        np.testing.assert_array_equal(got, np.asarray(want, float).reshape(-1, 2))
    np.testing.assert_array_equal(ours["position"], pos)
    assert ours["xy"].shape[1] == 2 and ours["beam"][ConeTypes.LEFT]["configs"].ndim == 2


def test_draw_writes_a_png(both, tmp_path):
    name, ours, _ = both
    out = tmp_path / f"{name}.png"
    stage_viz.draw(ours, str(out))
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and out.stat().st_size > 20_000


def test_cli_lists_the_scenarios(capsys):
    stage_viz.main(["--list"])
    assert capsys.readouterr().out.split() == sorted(ALL_SCENARIOS)


def _run_code_cells(path: Path) -> dict:
    """Execute a notebook's code cells in order in one namespace, the
    figures drawn by matplotlib's Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    namespace: dict = {}
    for cell in nbformat.read(path, as_version=4).cells:
        if cell.cell_type == "code":
            exec(compile(cell.source, f"{path.name} cell", "exec"), namespace)  # noqa: S102
    plt.close("all")
    return namespace


def test_notebook_runs_and_matches_the_jax_notebook():
    ours = _run_code_cells(REPO / "ft_fsd_path_planning_torch/demo/simple_application.ipynb")
    theirs = _run_code_cells(REPO / "ft_fsd_path_planning_tpu/demo/simple_application.ipynb")
    assert ours["DEVICE"] == "cpu" and ours["planner"].device == torch.device("cpu")
    for name in ("path", "path2"):
        assert ours[name].shape == (40, 4) and np.isfinite(ours[name]).all()
        assert path_parity_deviation(theirs[name], ours[name]) < 0.01, name
    np.testing.assert_array_equal(ours["l2r"], theirs["l2r"])
    for name in ("sorted_left", "sorted_right", "left_v", "right_v"):
        assert ours[name].shape == theirs[name].shape, name
        np.testing.assert_allclose(ours[name], theirs[name], atol=1e-4, err_msg=name)


def test_stage_data_refuses_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stage_viz.stage_data("hairpin")
