"""The port's spans and counters (`utils/timer.py::span`, `count`).

* Outside ``recording()`` and with no profiler running nothing is recorded.
* Inside it, a few facade frames give every span of the mission, nested as
  the program nests them, FITPACK's trip counters add up to `loop_syncs`,
  and a trackdrive frame opens the sorter's and the matcher's span once and
  counts one launch of B2 (`sorting.b2.launches`).
* A function under ``spanned`` keeps its name and its result, and records
  its calls only while recording.
* Under `torch.profiler` the spans are ranges of the trace, each named
  ``stage.*`` and inside ``stage.facade.call``, and the table fills with no
  ``recording()``.
* Wrappers put around the stage functions and the kernel entries by module
  attribute, as the benchmark's probes put them, are still called.
"""

import importlib.util
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import pytest
import torch

from ft_fsd_path_planning_torch import PathPlanner
from ft_fsd_path_planning_torch.config import SortingConfig, default_config
from ft_fsd_path_planning_torch.models import facade, matching, pathing, planner, relocalization, sorting
from ft_fsd_path_planning_torch.ops import banded_cholesky as bc
from ft_fsd_path_planning_torch.ops import beam_search as bs
from ft_fsd_path_planning_torch.ops import fitpack, spline
from ft_fsd_path_planning_torch.parallel.scenarios import closed_track_frames, make_frame_batch, skidpad_session
from ft_fsd_path_planning_torch.utils import timer
from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes

torch.set_num_threads(1)

FACADE = ("stage.facade.call", "stage.facade.step", "stage.facade.upload", "stage.facade.fetch")
FITPACK = ("stage.fitpack.fit", "stage.fitpack.part1", "stage.fitpack.insert", "stage.fitpack.part2",
           "stage.fitpack.root_rati")
#: the spans each mission's frames open, and its counters
PATHING = ("stage.pathing.run", "stage.pathing.param_tail")
SPANS = {
    "skidpad": FACADE + ("stage.facade.refine_f64", "stage.reloc.attempt") + PATHING + FITPACK,
    "trackdrive": FACADE + ("stage.sorting.run", "stage.matching.run") + PATHING + FITPACK,
}
TRIPS = {f"fitpack.trips.{loop}" for loop in ("part1", "insert", "part2", "root_rati")}
#: each mission's counters (the recorded frames run B2's plain version)
COUNTERS = {"skidpad": TRIPS, "trackdrive": TRIPS | {"sorting.b2.launches"}}
MISSIONS = sorted(SPANS)
#: (mission, inner, outer): the inner span's time lies inside the outer one's
NESTED = [
    (mission, inner, outer)
    for mission in MISSIONS
    for inner, outer in [
        ("stage.facade.step", "stage.facade.call"),
        ("stage.pathing.run", "stage.facade.step"),
        ("stage.reloc.attempt", "stage.facade.step") if mission == "skidpad"
        else ("stage.facade.upload", "stage.facade.call"),
        ("stage.fitpack.fit", "stage.pathing.run"),
        ("stage.pathing.param_tail", "stage.pathing.run"),
        ("stage.fitpack.part1", "stage.fitpack.fit"),
        ("stage.fitpack.root_rati", "stage.fitpack.part2"),
    ]
] + [
    ("trackdrive", "stage.sorting.run", "stage.facade.step"),
    ("trackdrive", "stage.matching.run", "stage.facade.step"),
]


def _frames(mission: str):
    if mission == "skidpad":
        return MissionTypes.skidpad, None, skidpad_session(n_frames=3)
    return MissionTypes.trackdrive, default_config(n_cones=256), closed_track_frames(seed=1, n_frames=2)


class _Calls:
    """A wrapper that counts the calls of ``fn`` and passes them on."""

    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, *args, **kwargs):
        self.n += 1
        return self.fn(*args, **kwargs)


@pytest.fixture(scope="module")
def recorded(request):
    """A new planner's first frames inside ``recording()``: (mission, the
    table, FITPACK's loop syncs over them, the number of frames)."""
    mission, cfg, frames = _frames(request.param)
    try:
        p = PathPlanner(mission, config=cfg, device="cpu")
        timer.reset()
        syncs0 = fitpack.loop_syncs
        with timer.recording():
            for cones, position, direction in frames:
                p.calculate_path_in_global_frame(cones, position, direction)
        syncs = fitpack.loop_syncs - syncs0
        table = timer.table()
    finally:
        timer.reset()
    return request.param, table, syncs, len(frames)


def test_nothing_is_recorded_outside_recording():
    _, _, frames = _frames("skidpad")
    p = PathPlanner(MissionTypes.skidpad, device="cpu")
    timer.reset()
    p.calculate_path_in_global_frame(*frames[0])
    assert timer.table() == {}


@pytest.mark.parametrize("recorded", MISSIONS, indirect=True)
def test_every_span_of_the_mission_is_recorded(recorded):
    mission, table, _, n_frames = recorded
    spans = {k for k, v in table.items() if isinstance(v, dict)}
    assert spans == set(SPANS[mission])
    assert set(table) - spans == COUNTERS[mission]
    assert table["stage.facade.call"]["n"] == n_frames
    assert all(k.startswith("stage.") for k in spans)
    assert all(table[k]["ns"] > 0 for k in spans)


@pytest.mark.parametrize(
    "recorded,inner,outer", NESTED, indirect=["recorded"], ids=[f"{m}: {i} in {o}" for m, i, o in NESTED]
)
def test_spans_nest(recorded, inner, outer):
    _, table, _, _ = recorded
    assert table[inner]["n"] >= 1
    assert table[inner]["ns"] <= table[outer]["ns"]


@pytest.mark.parametrize("recorded", MISSIONS, indirect=True)
def test_fitpack_trips_add_up_to_loop_syncs(recorded):
    _, table, syncs, _ = recorded
    trips = {k: v for k, v in table.items() if k.startswith("fitpack.trips.")}
    assert set(trips) == TRIPS
    assert sum(trips.values()) == syncs > 0
    # the gate of part 2 is checked once a fit
    assert trips["fitpack.trips.part2"] == table["stage.fitpack.fit"]["n"]


SPANNED = [
    (pathing.run_path_calculation, "stage.pathing.run"),
    (pathing.parameterize_tail, "stage.pathing.param_tail"),
    (relocalization.attempt_relocalization, "stage.reloc.attempt"),
    (facade.PathPlanner.calculate_path_in_global_frame, "stage.facade.call"),
    (facade.PathPlanner._refine_reloc_f64, "stage.facade.refine_f64"),
    (fitpack.fitpack_fit, "stage.fitpack.fit"),
    (fitpack._root_rati, "stage.fitpack.root_rati"),
    (sorting.run_cone_sorting, "stage.sorting.run"),
    (matching.run_cone_matching, "stage.matching.run"),
]


@pytest.mark.parametrize("fn,name", SPANNED, ids=[name for _, name in SPANNED])
def test_spanned_functions_keep_their_name(fn, name):
    assert fn.__wrapped__.__name__ == fn.__name__
    assert fn.__wrapped__.__doc__ == fn.__doc__
    assert fn.__module__.startswith("ft_fsd_path_planning_torch.")


@pytest.mark.parametrize("recording", [False, True])
def test_spanned_records_its_calls_only_while_recording(recording):
    @timer.spanned("stage.x")
    def twice(x):
        """Twice x."""
        return 2 * x

    @timer.spanned("stage.y")
    def fails():
        raise ValueError("inside")

    timer.reset()
    with timer.recording() if recording else nullcontext():
        assert twice(3) == 6 and twice(4) == 8
        with pytest.raises(ValueError, match="inside"):
            fails()
    table = timer.table()
    timer.reset()
    assert twice.__name__ == "twice" and twice.__doc__ == "Twice x."
    if recording:
        assert table["stage.x"]["n"] == 2 and table["stage.y"]["n"] == 1
        assert set(table) == {"stage.x", "stage.y"}
    else:
        assert table == {}


def test_spans_are_ranges_of_the_profilers_trace():
    from torch.profiler import ProfilerActivity, profile

    _, _, frames = _frames("skidpad")
    p = PathPlanner(MissionTypes.skidpad, device="cpu")
    p.calculate_path_in_global_frame(*frames[0])
    timer.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        p.calculate_path_in_global_frame(*frames[1])
    table = timer.table()
    timer.reset()
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("stage.")]
    spans = {k for k, v in table.items() if isinstance(v, dict)}
    assert "stage.fitpack.fit" in spans and table["fitpack.trips.part1"] > 0
    assert {name for name, _, _ in ranges} == spans
    (call,) = [(s, e) for name, s, e in ranges if name == "stage.facade.call"]
    assert all(call[0] <= s and e <= call[1] for _, s, e in ranges)
    assert sum(1 for name, _, _ in ranges if name == "stage.fitpack.fit") == table["stage.fitpack.fit"]["n"]


def test_stage_functions_patched_by_module_attribute_are_still_called(monkeypatch):
    """As the benchmark patches `pathing.run_path_calculation` and
    `relocalization.attempt_relocalization` (a `record_function` marker, or
    synchronises): the planner reaches them through the module, and the
    program's own span opens inside the patch, so that it is the innermost
    range of the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def marked(name, fn):
        def run(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return _Calls(run)

    run_path = marked("stage.pathing", planner.pathing.run_path_calculation)
    attempt = marked("stage.reloc", planner.relocalization.attempt_relocalization)
    monkeypatch.setattr(planner.pathing, "run_path_calculation", run_path)
    monkeypatch.setattr(planner.relocalization, "attempt_relocalization", attempt)
    _, _, frames = _frames("skidpad")
    p = PathPlanner(MissionTypes.skidpad, device="cpu")
    timer.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for frame in frames[:2]:
            p.calculate_path_in_global_frame(*frame)
    table = timer.table()
    timer.reset()
    assert run_path.n == attempt.n == 2
    assert table["stage.pathing.run"]["n"] == table["stage.reloc.attempt"]["n"] == 2
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        ranges.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    for marker, span in (("stage.pathing", "stage.pathing.run"), ("stage.reloc", "stage.reloc.attempt")):
        assert len(ranges[marker]) == len(ranges[span]) == 2
        for (ms, me), (ss, se) in zip(sorted(ranges[marker]), sorted(ranges[span])):
            assert ms <= ss and se <= me


def test_kernel_entries_patched_by_module_attribute_are_still_called(monkeypatch):
    """The solve and the search reach B1's fused and bare entries and B2 through
    the module attributes the benchmark's launch probe patches (a tensor on
    the meta device takes the card's branch with no card)."""
    calls = []

    def fake(name):
        def run(a, rhs, *args, **kwargs):
            calls.append(name)
            return torch.empty_like(rhs)
        return run

    monkeypatch.setattr(spline, "banded_refined_solve_cuda", fake("B1 fused"))
    monkeypatch.setattr(bc, "banded_cholesky_solve_cuda", fake("B1 bare"))
    monkeypatch.setattr(bs, "fused_beam_search_cuda", lambda *a, **kw: calls.append("B2") or (a[1], a[2]))
    a = torch.empty((3, 8, 8), device="meta")
    rhs = torch.empty((3, 8, 2), device="meta")
    spline._solve_spd_banded(a, rhs)
    bc.banded_cholesky_solve(torch.empty((3, 8, 9), device="meta"), rhs)
    bs.fused_beam_search(a, rhs, rhs, rhs, k=32, l=12, c=5, weights=(), gates={})
    assert calls == ["B1 fused", "B1 bare", "B2"]


def test_sorter_reaches_the_fused_search_through_its_module(monkeypatch):
    search = _Calls(bs.fused_beam_search)
    monkeypatch.setattr(bs, "fused_beam_search", search)
    _, cfg, frames = _frames("trackdrive")
    cones, position, direction = frames[0]
    p = PathPlanner(MissionTypes.trackdrive, config=cfg, device="cpu")
    timer.reset()
    with timer.recording():
        path = p.calculate_path_in_global_frame(cones, position, direction)
    table = timer.table()
    timer.reset()
    assert path.shape == (40, 4) and np.all(np.isfinite(path))
    assert search.n == 1
    assert sorting.bs is bs
    # the program's own spans of the two stages, and the launch counted
    assert table["stage.sorting.run"]["n"] == table["stage.matching.run"]["n"] == 1
    assert table["sorting.b2.launches"] == 1


@pytest.mark.parametrize("recorded", ["trackdrive"], indirect=True)
def test_sorting_and_matching_spans_open_once_a_trackdrive_frame(recorded):
    _, table, _, n_frames = recorded
    assert table["stage.sorting.run"]["n"] == table["stage.matching.run"]["n"] == n_frames
    assert table["sorting.b2.launches"] == n_frames  # one launch searches both sides


def test_trackdrive_records_nothing_outside_recording():
    _, cfg, frames = _frames("trackdrive")
    p = PathPlanner(MissionTypes.trackdrive, config=cfg, device="cpu")
    timer.reset()
    p.calculate_path_in_global_frame(*frames[0])
    assert timer.table() == {}


def test_b2_launches_are_counted_on_the_fused_path_only(monkeypatch):
    """`sorting.b2.launches` counts the calls of B2 (its plain version on the
    CPU), one a sorter call."""
    search = _Calls(bs.fused_beam_search)
    monkeypatch.setattr(bs, "fused_beam_search", search)
    _, cfg, frames = _frames("trackdrive")
    p = PathPlanner(MissionTypes.trackdrive, config=cfg, device="cpu")
    timer.reset()
    with timer.recording():
        for frame in frames:
            p.calculate_path_in_global_frame(*frame)
    table = timer.table()
    timer.reset()
    assert table["stage.sorting.run"]["n"] == len(frames)
    assert search.n == len(frames)
    assert table.get("sorting.b2.launches", 0) == search.n


def test_a_search_off_the_cpu_at_a_shape_the_kernel_does_not_take_counts_no_launch(monkeypatch):
    """Off the CPU (a meta tensor stands for the card's) the sorter reaches
    the search at beam width 10, which the kernel does not take: the search
    raises before anything runs, and `sorting.b2.launches` counts nothing."""
    search = _Calls(bs.fused_beam_search)
    monkeypatch.setattr(bs, "fused_beam_search", search)
    cfg = default_config(n_cones=64, sorting=SortingConfig(beam_width=10))
    frames = make_frame_batch(cfg, 2, seed=0, device="cpu")
    meta = [t.to("meta") for t in (frames.cones, frames.mask, frames.position, frames.direction)]
    timer.reset()
    bs.reset_launch_count()
    with timer.recording(), pytest.raises(bs.UnsupportedShape, match=r"\(10, 12, 5\)"):
        sorting.run_cone_sorting(cfg, *meta)
    table = timer.table()
    timer.reset()
    assert search.n == 1 and bs.launch_count == 0
    assert table["stage.sorting.run"]["n"] == 1
    assert "sorting.b2.launches" not in table


def test_off_path_records_nothing_and_allocates_no_span():
    timer.reset()
    first, second = timer.span("stage.x"), timer.span("stage.y")
    assert first is second  # one shared object, nothing made per call
    with first:
        timer.count("c")
    assert timer.table() == {}
    with timer.recording():
        with timer.span("stage.x"):
            timer.count("c", 3)
        with timer.recording():
            timer.count("c")
    timer.count("c")
    table = timer.table()
    timer.reset()
    assert table["c"] == 4 and table["stage.x"]["n"] == 1
    assert timer.table() == {}


PART2_SHARE = Path(__file__).resolve().parents[1] / "benchmark" / "metrics" / "fitpack_part2_kernel_share.py"
FITS = {"stage.fitpack.fit": {"n": 4, "ns": 1}}


@pytest.mark.parametrize("table,want", [
    ({**FITS, "fitpack.part2.launches": 4}, 1.0),
    ({**FITS, "fitpack.part2.launches": 2}, 0.5),
    ({**FITS, "fitpack.trips.part2": 4, "fitpack.trips.root_rati": 30}, None),  # the masked loop: no launch
    ({}, None),
], ids=["every fit", "half the fits", "no counter", "nothing recorded"])
def test_part2_kernel_share_is_launches_over_fits(table, want, monkeypatch):
    """The benchmark's reader of `fitpack.part2.launches` (the counter the
    part-2 kernel's wrapper adds to once a launch): launches over the calls
    of `stage.fitpack.fit`, or nothing where the program has no counter."""
    spec = importlib.util.spec_from_file_location("fitpack_part2_kernel_share", PART2_SHARE)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    monkeypatch.setattr(timer, "table", lambda: table)
    assert reader.read({"units": 3}) == want
