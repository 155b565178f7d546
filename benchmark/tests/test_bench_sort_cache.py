"""`sort_cache_hit_share.online` and `sort_cache_host_ms.online`, the cell
`trackdrive.online-cached`'s metrics of the facade's sorting-result cache:
the counter `facade.sort_cache.hits` over `facade.sort_cache.lookups`, and
the host ms a frame of the span `stage.facade.sort_cache`. Read from a
table recorded on the CPU over a few of the cell's frames; a program
without the counters or the span (the parent of the commit that added
them) gives nothing. Also the plain reference of the cache's hit rule
(`reference/sort_cache.py`) on frames made to hit and to miss."""

import numpy as np
import pytest

from harness import cell as cells
from harness.frames import Frame
from reference import sort_cache

CELL = "trackdrive.online-cached"
SHARE, HOST_MS = "sort_cache_hit_share.online", "sort_cache_host_ms.online"


@pytest.mark.parametrize("name", [SHARE, HOST_MS])
def test_the_metric_is_the_cells_alone_and_has_a_reader(name):
    (metric,) = [m for m in cells.load_cell(CELL).per_layer if m["name"] == name]
    assert metric["layer"] == "facade sort cache (models/facade.py)" and metric["moves"] == "plan_ms_p50"
    assert metric["workloads"] == [CELL]
    assert callable(cells.metric_reader(name).read)
    for other in ("trackdrive.laps", "skidpad.online"):
        assert name not in {m["name"] for m in cells.load_cell(other).per_layer}


@pytest.fixture(scope="module")
def recorded():
    """(ctx, the table) over six traced frames of the cell on the CPU."""
    import torch
    from ft_fsd_path_planning_torch.utils import timer

    torch.set_num_threads(1)
    cell = cells.load_cell(CELL)
    cell.traffic.update(warmup_frames=1, trace_after_frames=1, trace_frames=6)
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
    hits = loop.planner.sort_cache_hits
    return {"units": units}, table, hits


def _read(name, ctx, table, monkeypatch):
    from ft_fsd_path_planning_torch.utils import timer

    monkeypatch.setattr(timer, "table", lambda: table)
    return cells.metric_reader(name).read(ctx)


def test_hit_share_is_hits_over_lookups(recorded, monkeypatch):
    ctx, table, _ = recorded
    assert table["facade.sort_cache.lookups"] == ctx["units"] == 6
    hits = table.get("facade.sort_cache.hits", 0)
    assert _read(SHARE, ctx, table, monkeypatch) == hits / 6
    assert _read(SHARE, ctx, dict(table, **{"facade.sort_cache.hits": 3}), monkeypatch) == 0.5
    no_hit = {k: v for k, v in table.items() if k != "facade.sort_cache.hits"}
    assert _read(SHARE, ctx, no_hit, monkeypatch) == 0.0


def test_host_ms_is_the_span_a_frame(recorded, monkeypatch):
    ctx, table, _ = recorded
    span = table["stage.facade.sort_cache"]
    assert span["n"] == ctx["units"]
    assert _read(HOST_MS, ctx, table, monkeypatch) == pytest.approx(span["ns"] / 1e6 / 6)
    assert 0 < span["ns"] < table["stage.facade.call"]["ns"]
    made = {"stage.facade.sort_cache": {"n": 6, "ns": 12_000_000}}
    assert _read(HOST_MS, ctx, made, monkeypatch) == pytest.approx(2.0)


@pytest.mark.parametrize("name", [SHARE, HOST_MS])
@pytest.mark.parametrize("table", [{}, {"stage.facade.call": {"n": 6, "ns": 5}, "stage.facade.step": {"n": 6, "ns": 4},
                                        "sorting.b2.launches": 6}],
                         ids=["nothing recorded", "a program without the cache's counters and span"])
def test_nothing_without_the_counter_or_span(name, table, monkeypatch):
    assert _read(name, {"units": 6}, table, monkeypatch) is None


def _frame(left, right, unknown, position=(0.0, 0.0)):
    empty = np.zeros((0, 2))
    return Frame([unknown, right, left, empty, empty], np.asarray(position, float), np.array([1.0, 0.0]))


def _corridor():
    x = np.arange(-7.0, 30.0, 3.5)
    left = np.stack([x, np.full_like(x, 1.5)], axis=1)
    right = np.stack([x, np.full_like(x, -1.5)], axis=1)
    return left, right, np.array([[10.0, 12.0]])


def test_the_reference_rule_hits_within_the_threshold_and_misses_beyond():
    left, right, unknown = _corridor()
    first = _frame(left, right, unknown)
    assert sort_cache.hit_sequence([first, first]) == [False, True]
    near = _frame(left + [0.099, 0.0], right, unknown)
    far = _frame(left, right, unknown + [0.0, 0.101])
    assert sort_cache.is_hit(first, near) and not sort_cache.is_hit(first, far)
    assert sort_cache.distances(first, far)["map"] == pytest.approx(0.101)
    # the car passes a cone: a start cone changes, the map does not
    moved = _frame(left, right, unknown, position=(3.5, 0.0))
    d = sort_cache.distances(first, moved)
    assert d["map"] == 0.0 and d["start_left"] > 3.0 and not sort_cache.is_hit(first, moved)


def test_the_reference_rule_reads_colours_and_counts():
    left, right, unknown = _corridor()
    first = _frame(left, right, unknown)
    swapped = _frame(left, right[:-1], np.concatenate([unknown, right[-1:]]))
    assert sort_cache.distances(first, swapped)["map"] == float("inf")
    fewer = _frame(left, right, unknown[:0])
    assert sort_cache.distances(first, fewer)["map"] == float("inf")
    assert not sort_cache.is_hit(first, swapped) and not sort_cache.is_hit(first, fewer)
