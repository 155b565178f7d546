"""`param_kernel_share.online`: the counter `pathing.param_kernel.launches`
over the calls of `stage.pathing.param_tail`. On a CPU run of
trackdrive.laps' frames the plain version parameterizes and the share reads
0.0; one launch a call reads 1.0; a program without the span, or without a
parameterization kernel (the parent of the kernel's commit), gives
nothing."""

import pytest

from harness import cell as cells

CELLS = ("skidpad.online", "trackdrive.laps", "trackdrive.online-cached")
NAME = "param_kernel_share.online"


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_metric_is_every_cells_and_has_a_reader(cell_name):
    cell = cells.load_cell(cell_name)
    (metric,) = [m for m in cell.per_layer if m["name"] == NAME]
    assert metric["layer"] == "path calculation (models/pathing.py)" and metric["moves"] == "plan_ms_p50"
    assert metric["source"] == "program_counter" and metric["unit"] == "share"
    assert callable(cells.metric_reader(NAME).read)


@pytest.fixture(scope="module")
def recorded():
    """(ctx, the table) over two traced frames of short laps on the CPU."""
    import torch
    from ft_fsd_path_planning_torch.utils import timer

    torch.set_num_threads(1)
    cell = cells.load_cell("trackdrive.laps")
    cell.traffic.update(closed_track={"frames_per_lap": 10, "jitter_m": 0.02}, warmup_frames=1,
                        trace_after_frames=1, trace_frames=2)
    loop = cells.loop_module(cell).Loop(cell, 2**31 + 18, cells.track_module(cell), "cpu")
    loop.setup()
    loop.to_traced()
    timer.reset()
    try:
        with timer.recording():
            units = loop.traced_units()
        table = timer.table()
    finally:
        timer.reset()
    return {"units": units}, table


def _read(ctx, table, monkeypatch):
    from ft_fsd_path_planning_torch.utils import timer

    monkeypatch.setattr(timer, "table", lambda: table)
    return cells.metric_reader(NAME).read(ctx)


def test_the_cpu_runs_the_plain_version(recorded, monkeypatch):
    ctx, table = recorded
    assert table["stage.pathing.param_tail"]["n"] == ctx["units"] and "pathing.param_kernel.launches" not in table
    assert _read(ctx, table, monkeypatch) == 0.0


def test_one_launch_a_call_reads_one(recorded, monkeypatch):
    ctx, table = recorded
    launched = dict(table, **{"pathing.param_kernel.launches": table["stage.pathing.param_tail"]["n"]})
    assert _read(ctx, launched, monkeypatch) == 1.0


@pytest.mark.parametrize("table", [{}, {"stage.pathing.run": {"n": 2, "ns": 5}, "matching.kernel.launches": 2}],
                         ids=["nothing recorded", "a program without the span"])
def test_nothing_without_the_span(table, monkeypatch):
    assert _read({"units": 2}, table, monkeypatch) is None


def test_nothing_from_a_program_without_the_kernel(monkeypatch):
    from ft_fsd_path_planning_torch.models import pathing

    monkeypatch.delattr(pathing, "parameterize_tail_cuda")
    assert _read({"units": 2}, {"stage.pathing.param_tail": {"n": 2, "ns": 5}}, monkeypatch) is None
