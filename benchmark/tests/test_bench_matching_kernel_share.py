"""`matching_kernel_share.online`: the counter `matching.kernel.launches`
over the calls of `stage.matching.run`. On a CPU run of trackdrive.laps'
frames the plain version matches and the share reads 0.0; one launch a
call reads 1.0; a program without the span, or without a matching kernel
(the parent of the kernel's commit), gives nothing."""

import pytest

from harness import cell as cells

CELL = "trackdrive.laps"
NAME = "matching_kernel_share.online"


def test_the_metric_is_the_cells_and_has_a_reader():
    cell = cells.load_cell(CELL)
    (metric,) = [m for m in cell.per_layer if m["name"] == NAME]
    assert metric["layer"] == "cone matching (models/matching.py)" and metric["moves"] == "plan_ms_p50"
    assert callable(cells.metric_reader(NAME).read)
    assert NAME not in {m["name"] for m in cells.load_cell("skidpad.online").per_layer}


@pytest.fixture(scope="module")
def recorded():
    """(ctx, the table) over two traced frames of short laps on the CPU."""
    import torch
    from ft_fsd_path_planning_torch.utils import timer

    torch.set_num_threads(1)
    cell = cells.load_cell(CELL)
    cell.traffic.update(closed_track={"frames_per_lap": 10, "jitter_m": 0.02}, warmup_frames=1,
                        trace_after_frames=1, trace_frames=2)
    loop = cells.loop_module(cell).Loop(cell, 2**31 + 17, cells.track_module(cell), "cpu")
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
    assert table["stage.matching.run"]["n"] == ctx["units"] and "matching.kernel.launches" not in table
    assert _read(ctx, table, monkeypatch) == 0.0


def test_one_launch_a_call_reads_one(recorded, monkeypatch):
    ctx, table = recorded
    launched = dict(table, **{"matching.kernel.launches": table["stage.matching.run"]["n"]})
    assert _read(ctx, launched, monkeypatch) == 1.0


@pytest.mark.parametrize("table", [{}, {"stage.sorting.run": {"n": 2, "ns": 5}, "sorting.b2.launches": 2}],
                         ids=["nothing recorded", "a program without the span"])
def test_nothing_without_the_span(table, monkeypatch):
    assert _read({"units": 2}, table, monkeypatch) is None


def test_nothing_from_a_program_without_the_kernel(monkeypatch):
    from ft_fsd_path_planning_torch.models import matching

    monkeypatch.delattr(matching, "run_cone_matching_cuda")
    assert _read({"units": 2}, {"stage.matching.run": {"n": 2, "ns": 5}}, monkeypatch) is None
