"""The readers of the program's spans and counters on a CPU run of
`skidpad.online`'s frames inside `utils/timer.py::recording()`, as the
traced run records them under the profiler, with the launch probe in place:
each gives a finite number, the trips a fit times the fits a frame are the
loop syncs a frame, and a program without the spans gives nothing."""

import math

import pytest

import trackdrive_cells
from harness import cell as cells
from harness import probes

READERS = ("facade_host_ms.online", "pathing_host_ms.online", "reloc_host_ms.online",
           "fitpack_trips_per_fit.online", "b1_solves_per_frame.online")


@pytest.fixture(scope="module")
def recorded():
    """(ctx as the traced run builds it, the table) over three frames."""
    import torch
    from ft_fsd_path_planning_torch.ops import fitpack
    from ft_fsd_path_planning_torch.utils import timer

    torch.set_num_threads(1)
    cell = trackdrive_cells.load("skidpad.online")
    cell.traffic.update(skidpad={"stride": 200}, warmup_frames=1, trace_after_frames=2, trace_frames=3)
    loop = cells.loop_module(cell).Loop(cell, 2**31 + 11, cells.track_module(cell), "cpu")
    loop.setup()
    loop.to_traced()
    timer.reset()
    launches = probes.Launches()
    syncs0 = fitpack.loop_syncs
    with timer.recording(), launches.active():
        units = loop.traced_units()
    ctx = {"units": units, "loop_syncs": fitpack.loop_syncs - syncs0, "launches": launches}
    table = timer.table()
    timer.reset()
    return ctx, table


def _read(name, ctx, table, monkeypatch):
    from ft_fsd_path_planning_torch.utils import timer

    monkeypatch.setattr(timer, "table", lambda: table)
    return cells.metric_reader(name).read(ctx)


def test_the_readers_are_the_cells_metrics():
    cell = trackdrive_cells.load("skidpad.online")
    assert set(READERS) <= {m["name"] for m in cell.per_layer}


@pytest.mark.parametrize("name", READERS)
def test_each_reader_gives_a_finite_number(recorded, name, monkeypatch):
    ctx, table = recorded
    value = _read(name, ctx, table, monkeypatch)
    assert value is not None and math.isfinite(value)
    # the CPU solves in plain PyTorch and launches no B1; every span and
    # counter of the frame is there
    assert value == 0 if name == "b1_solves_per_frame.online" else value > 0


def test_b1_solves_are_the_launch_probes_count_a_frame():
    launches = probes.Launches()
    launches.count["B1"] = 78
    reader = cells.metric_reader("b1_solves_per_frame.online")
    assert reader.read({"units": 3, "launches": launches}) == 26


def test_trips_a_fit_times_fits_a_frame_are_the_loop_syncs(recorded, monkeypatch):
    ctx, table = recorded
    trips_per_fit = _read("fitpack_trips_per_fit.online", ctx, table, monkeypatch)
    fits_per_frame = table["stage.fitpack.fit"]["n"] / ctx["units"]
    loop_syncs = _read("fitpack_loop_syncs.online", ctx, table, monkeypatch)
    assert trips_per_fit * fits_per_frame == pytest.approx(loop_syncs, rel=1e-12)


def test_host_times_sit_inside_the_facade_call(recorded, monkeypatch):
    ctx, table = recorded
    call_ms = table["stage.facade.call"]["ns"] / 1e6 / ctx["units"]
    parts = [_read(n, ctx, table, monkeypatch) for n in
             ("facade_host_ms.online", "pathing_host_ms.online", "reloc_host_ms.online")]
    assert sum(parts) <= call_ms


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_table_gives_nothing(name, monkeypatch):
    from ft_fsd_path_planning_torch.utils import timer

    ctx = {"units": 3, "loop_syncs": 87}
    assert _read(name, ctx, {}, monkeypatch) is None
    monkeypatch.delattr(timer, "table")
    assert cells.metric_reader(name).read(ctx) is None
