"""The parameterization tail's dispatch and the kernel's wrapper, on the CPU:
CPU tensors take the plain version and launch and count nothing; any other
device takes the kernel, whose wrapper refuses what the kernel does not
take before it launches; a planner for the card refuses a curvature window
or a horizon the kernel does not take. The circle fit's batched loop gives
each window what that window gives run alone to its own end, the property
the kernel's per-window Newton rests on. The judgement of
`tests/param_check.py`, which holds the kernel to the plain version on the
card, is held here on plain results made wrong on purpose.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ft_fsd_path_planning_torch.config import default_config
from ft_fsd_path_planning_torch.models import facade
from ft_fsd_path_planning_torch.models import pathing
from ft_fsd_path_planning_torch.ops import fitpack as fpk
from ft_fsd_path_planning_torch.ops import geometry as geo
from ft_fsd_path_planning_torch.ops.beam_search import UnsupportedShape
from ft_fsd_path_planning_torch.ops.curvature import _rolled_windows
from ft_fsd_path_planning_torch.utils import timer
from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes
from tests import param_check as pc

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def edge():
    """(names, fit, predict_every) of the edge lanes on the CPU."""
    return pc.edge_input("cpu")


def _with(cfg, window=None, horizon=None):
    shapes = cfg.shapes if window is None else dataclasses.replace(cfg.shapes, curvature_window=window)
    path = cfg.path if horizon is None else dataclasses.replace(cfg.path, mpc_prediction_horizon=horizon)
    return dataclasses.replace(cfg, shapes=shapes, path=path)


def test_edge_lanes_keep_the_samples_they_ask_for(edge):
    names, fit, every = edge
    got = pathing.parameterize_tail_plain(pc.edge_configs()["W=31"], fit, every, 192).n_pts.tolist()
    want = [0 if name.startswith("one point") else n for (_, _, n), name in zip(pc.EDGE_LANES, names)]
    assert got == want
    assert {108, 112, 176, 184, 192, 40, 39, 0} <= set(got)


@pytest.mark.parametrize("label", list(pc.edge_configs()))
def test_cpu_takes_the_plain_version_and_launches_nothing(edge, label):
    _, fit, every = edge
    cfg = pc.edge_configs()[label]
    pathing.reset_launch_count()
    timer.reset()
    try:
        with timer.recording():
            got = pathing.parameterize_tail(cfg, fit, every, 192)
            table = timer.table()
    finally:
        timer.reset()
    want = pathing.parameterize_tail_plain(cfg, fit, every, 192)
    assert pathing.launch_count == 0
    assert table.get("pathing.param_kernel.launches", 0) == 0
    assert table["stage.pathing.param_tail"]["n"] == 1
    for name in pathing.ParamTail._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and bool(pc._same(a, b).all()), name
    assert got.out.shape == (fit.ok.shape[0], cfg.path.mpc_prediction_horizon, 4)
    assert got.n_pts.dtype == torch.int64 and got.indices.dtype == torch.int32


def test_a_planner_step_runs_the_tail_once_a_frame():
    """The span counts one call a _parameterize_path, here the stage's."""
    from ft_fsd_path_planning_torch import PathPlanner
    from tests import matching_check as mc

    planner = PathPlanner(MissionTypes.trackdrive, config=default_config(n_cones=256), device="cpu")
    frames = mc.lap_frames()[:2]
    calls = pc.capture(lambda: [planner.calculate_path_in_global_frame(*f) for f in frames])
    assert len(calls) == 2
    assert all(p == 192 and e.shape == (1,) for _, _, e, p in calls)


def _meta_fit(b: int) -> fpk.FpSpline:
    e = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device="meta")  # noqa: E731
    return fpk.FpSpline(e(b, fpk.MAX_INT), e(b, dtype=torch.int32), e(b, fpk.NC, 2), e(b), e(b, dtype=torch.bool),
                        e(b, dtype=torch.bool))


def test_dispatch_off_the_cpu_takes_the_kernel(monkeypatch):
    """Off the CPU (a meta tensor stands for the card's) the tail takes the
    kernel's wrapper and never the plain version."""
    calls = []
    monkeypatch.setattr(pathing, "parameterize_tail_cuda", lambda *a: calls.append("kernel"))
    monkeypatch.setattr(pathing, "parameterize_tail_plain", lambda *a: calls.append("plain"))
    pathing.parameterize_tail(default_config(), _meta_fit(3), torch.empty(3, device="meta"), 192)
    assert calls == ["kernel"]


def _good(edge):
    _, fit, every = edge
    return default_config(), fit, every, 192


#: inputs the wrapper refuses, and what it says: (make (cfg, fit, every, p) from a good one, error, message)
REFUSED = {
    "even window": (lambda c, f, e, p: (_with(c, window=30), f, e, p), UnsupportedShape, "curvature_window 30"),
    "window of 65": (lambda c, f, e, p: (_with(c, window=65), f, e, p), UnsupportedShape, "curvature_window 65"),
    "horizon of 1": (lambda c, f, e, p: (_with(c, horizon=1), f, e, p), UnsupportedShape, "mpc_prediction_horizon 1"),
    "horizon over p_eval": (lambda c, f, e, p: (c, f, e, 39), UnsupportedShape, "p_eval 39"),
    "257 samples": (lambda c, f, e, p: (c, f, e, 257), UnsupportedShape, "p_eval 257"),
    "float64 predict_every": (lambda c, f, e, p: (c, f, e.double(), p), TypeError, "predict_every must be torch.float32"),
    "int64 n_int": (lambda c, f, e, p: (c, f._replace(n_int=f.n_int.long()), e, p), TypeError, "n_int must be torch.int32"),
    "uint8 ok": (lambda c, f, e, p: (c, f._replace(ok=f.ok.to(torch.uint8)), e, p), TypeError, "ok must be torch.bool"),
    "mismatched B": (lambda c, f, e, p: (c, f, e[:3], p), ValueError, r"t_int must be \(3, 24\)"),
    "coefficients of another budget": (lambda c, f, e, p: (c, f._replace(coef=f.coef[:, :20]), e, p), ValueError,
                                       r"coef must be \(15, 28, 2\)"),
    "CPU tensors": (lambda c, f, e, p: (c, f, e, p), ValueError, "CUDA tensors"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(edge, case, monkeypatch):
    make, error, message = REFUSED[case]
    monkeypatch.setattr(pathing, "_library", lambda: pytest.fail("the wrapper reached the library"))
    pathing.reset_launch_count()
    with pytest.raises(error, match=message):
        pathing.parameterize_tail_cuda(*make(*_good(edge)))
    assert pathing.launch_count == 0


@pytest.mark.parametrize("window, horizon", [(31, 40), (15, 40), (63, 192), (30, 40), (65, 40), (31, 193), (31, 1)])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_planner_refuses_a_shape_the_kernel_does_not_take(monkeypatch, device, window, horizon):
    """A planner for the card (a meta device stands for it) raises
    UnsupportedShape at a window or horizon the kernel does not take, on
    every mission; on the CPU every shape runs the plain version."""
    monkeypatch.setattr(facade, "make_initial_state", lambda cfg, batch, dev: None)
    takes = pathing.kernel_supports(192, window, horizon)
    assert takes is (window % 2 == 1 and window <= 63 and 2 <= horizon <= 192)
    for mission in (MissionTypes.trackdrive, MissionTypes.skidpad):
        cfg = _with(default_config(mission), window=window, horizon=horizon)
        if device != "cpu" and not takes:
            with pytest.raises(UnsupportedShape, match="parameterization kernel does not take"):
                facade.PathPlanner(mission, config=cfg, device=device)
        else:
            assert facade.PathPlanner(mission, config=cfg, device=device).cfg == cfg


def test_a_small_dense_budget_sizes_the_tail():
    cfg = default_config()
    assert pathing.tail_samples(cfg) == 192
    small = dataclasses.replace(cfg, shapes=dataclasses.replace(cfg.shapes, dense_samples=100))
    assert pathing.tail_samples(small) == 100
    pathing.require_kernel_shape(small)
    with pytest.raises(UnsupportedShape, match="p_eval 30"):
        pathing.require_kernel_shape(dataclasses.replace(small, shapes=dataclasses.replace(small.shapes, dense_samples=30)))


@pytest.mark.parametrize("label", list(pc.edge_configs()))
def test_a_window_alone_ends_where_the_batched_loop_leaves_it(edge, label):
    """Every window of the edge lanes through `circle_fit` in one batch, whose
    loop runs until the last window has frozen, and each window alone, whose
    loop ends when it freezes: the same circle, bit for bit. Their trips
    differ: a third of the windows freeze before the batch's last does."""
    _, fit, every = edge
    cfg = pc.edge_configs()[label]
    pts, _, valid = fpk.fitpack_eval_every(fit, every, 192)
    n = torch.sum(valid, dim=1)
    w = cfg.shapes.curvature_window
    window = torch.clamp(n // 5, max=30)
    window = window + (window % 2 == 0).to(window.dtype)
    shalf = w // 2
    centers = torch.arange(192)[None, :, None]
    offs = torch.arange(w)[None, None, :]
    raw = centers - shalf + offs
    mask = (raw >= 0) & (raw < n[:, None, None]) & (torch.abs(offs - shalf) <= ((window - 1) // 2)[:, None, None])
    mask = mask & (centers < n[:, None, None])
    live = mask.any(dim=2)
    win, mask = _rolled_windows(pts, w)[live][::3], mask[live][::3]  # (N, W, 2), (N, W)
    batched = geo.circle_fit(win, mask)
    alone = torch.stack([geo.circle_fit(win[k : k + 1], mask[k : k + 1])[0] for k in range(win.shape[0])])
    assert win.shape[0] > 200
    assert bool(pc._same(batched, alone).all())
    early = [bool(pc._same(geo.circle_fit(win, mask, max_iter=k), batched).all(dim=1).float().mean() < 1)
             for k in (1, 2)]
    assert early == [True, True]


def test_judge_passes_the_plain_version_against_itself(edge):
    _, fit, every = edge
    for cfg in pc.edge_configs().values():
        want = pathing.parameterize_tail_plain(cfg, fit, every, 192)
        found = pc.Comparison()
        pc.judge(want, want, found, "itself")
        assert not found.faults and found.calls == 1 and found.short_lanes == 7


def _wrong(t: pathing.ParamTail, what: str, lane: int) -> pathing.ParamTail:
    out = t.out.clone()
    if what == "x one ulp off":
        out[lane, 5, 1] = torch.nextafter(out[lane, 5, 1], torch.tensor(np.inf))
    elif what == "u of another sample":
        out[lane, 7, 0] = out[lane, 8, 0]
    elif what == "y NaN":
        out[lane, 3, 2] = float("nan")
    elif what == "curvature one ulp off":
        out[lane, 10, 3] = torch.nextafter(out[lane, 10, 3], torch.tensor(-np.inf))
    elif what == "curvature sign flipped":
        out[lane, 10, 3] = -out[lane, 10, 3]
    elif what == "curvature NaN":
        out[lane, 0, 3] = float("nan")
    elif what == "index off by one":
        idx = t.indices.clone()
        idx[lane, -1] -= 1
        return t._replace(indices=idx)
    elif what == "ok flipped":
        ok = t.ok.clone()
        ok[lane] = ~ok[lane]
        return t._replace(ok=ok)
    elif what == "a sample more":
        return t._replace(n_pts=t.n_pts + (torch.arange(t.n_pts.shape[0]) == lane))
    elif what == "int32 count":
        return t._replace(n_pts=t.n_pts.int())
    return t._replace(out=out)


#: plain results made wrong on purpose, and the word the fault names
WRONG = {"x one ulp off": "x", "u of another sample": "u", "y NaN": "y", "curvature one ulp off": "curvature",
         "curvature sign flipped": "curvature", "curvature NaN": "curvature", "index off by one": "indices",
         "ok flipped": "ok", "a sample more": "n_pts", "int32 count": "n_pts"}


@pytest.mark.parametrize("what", list(WRONG))
def test_judge_finds_what_differs(edge, what):
    _, fit, every = edge
    want = pathing.parameterize_tail_plain(pc.edge_configs()["W=31"], fit, every, 192)
    found = pc.Comparison()
    pc.judge(_wrong(want, what, 1), want, found, what)  # lane 1: an arc of 15 m, 121 samples
    assert len(found.faults) == 1, found.faults
    assert f": {WRONG[what]} " in found.faults[0]
