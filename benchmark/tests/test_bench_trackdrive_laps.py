"""The cell `trackdrive.laps`: it resolves from BENCHMARK.json alone, every
metric it reports has a reader, and the readers of the sorter's and the
matcher's spans and of B2's launch counter give a number on a CPU run of the
cell's frames inside `utils/timer.py::recording()` (the sorter on B2's plain
version), and nothing for a program without them."""

import math

import pytest

import trackdrive_cells
from harness import cell as cells

CELL = "trackdrive.laps"
NEW_READERS = ("sorting_host_ms.online", "matching_host_ms.online", "b2_kernel_share.online")


def test_the_cell_resolves_from_the_benchmark():
    cell = cells.load_cell(CELL)
    assert cell.config_name == cell.config["name"] == "trackdrive-fsg"
    assert cell.chips == 1 and cell.config["reduced"] == []
    assert cell.traffic["loop"] == "online" and cell.config["track"]["kind"] == "closed_track"
    assert cells.loop_module(cell).Loop and cells.track_module(cell).Drive
    assert cell.config["check"]["path_gap_m"] == 0.01
    # the same cell as the one the CPU tests hold out under another name
    held = trackdrive_cells.load(trackdrive_cells.ONLINE)
    assert (held.config, held.traffic) == (cell.config, cell.traffic)


def test_every_metric_of_the_cell_has_a_reader():
    cell = cells.load_cell(CELL)
    e2e = {m["name"] for m in cell.end_to_end}
    assert e2e == {"plan_ms_p50", "plan_ms_p95", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert set(NEW_READERS) | {"sorting_ms.online", "matching_ms.online", "b2_roofline.online"} <= names
    assert not {"reloc_ms.online", "reloc_host_ms.online"} & names  # no relocalizer on trackdrive
    for m in cell.per_layer:
        assert callable(cells.metric_reader(m["name"]).read), m["name"]
        assert m["moves"] in e2e


@pytest.fixture(scope="module")
def recorded():
    """(ctx, the table) over two traced frames of short laps, B2's plain
    version in the sorter."""
    import os

    import torch
    from ft_fsd_path_planning_torch.utils import timer

    torch.set_num_threads(1)
    cell = cells.load_cell(CELL)
    cell.traffic.update(closed_track={"frames_per_lap": 10, "jitter_m": 0.02}, warmup_frames=1,
                        trace_after_frames=1, trace_frames=2)
    old = os.environ.get("FT_FSD_FUSED_BEAM")
    os.environ["FT_FSD_FUSED_BEAM"] = "1"
    try:
        loop = cells.loop_module(cell).Loop(cell, 2**31 + 13, cells.track_module(cell), "cpu")
        loop.setup()
        loop.to_traced()
        timer.reset()
        with timer.recording():
            units = loop.traced_units()
        table = timer.table()
    finally:
        timer.reset()
        if old is None:
            del os.environ["FT_FSD_FUSED_BEAM"]
        else:
            os.environ["FT_FSD_FUSED_BEAM"] = old
    return {"units": units}, table


def _read(name, ctx, table, monkeypatch):
    from ft_fsd_path_planning_torch.utils import timer

    monkeypatch.setattr(timer, "table", lambda: table)
    return cells.metric_reader(name).read(ctx)


@pytest.mark.parametrize("name", NEW_READERS)
def test_each_new_reader_gives_a_number(recorded, name, monkeypatch):
    ctx, table = recorded
    value = _read(name, ctx, table, monkeypatch)
    assert value is not None and math.isfinite(value) and value > 0
    assert table["stage.sorting.run"]["n"] == table["stage.matching.run"]["n"] == ctx["units"]


def test_one_b2_launch_a_sorter_call(recorded, monkeypatch):
    ctx, table = recorded
    assert _read("b2_kernel_share.online", ctx, table, monkeypatch) == 1.0
    # the scan counts no launch: the share falls to 0
    scan = {k: v for k, v in table.items() if k != "sorting.b2.launches"}
    assert _read("b2_kernel_share.online", ctx, scan, monkeypatch) == 0.0


@pytest.mark.parametrize("name", NEW_READERS)
@pytest.mark.parametrize("table", [{}, {"stage.pathing.run": {"n": 2, "ns": 5}, "fitpack.part2.launches": 6}],
                         ids=["nothing recorded", "a program without the spans"])
def test_new_readers_give_nothing_without_their_span_or_counter(name, table, monkeypatch):
    assert _read(name, {"units": 2}, table, monkeypatch) is None
