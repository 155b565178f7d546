"""fitpack_trips_per_fit.*: ops/fitpack.py: the program's counters
`fitpack.trips.*` (one a loop condition, one host sync each) summed, over
the calls of its span `stage.fitpack.fit`, in the traced window. None where
the program has no such counters."""


def read(ctx):
    try:
        from ft_fsd_path_planning_torch.utils.timer import table
    except ImportError:
        return None
    spans = table()
    fits = spans.get("stage.fitpack.fit")
    trips = sum(v for k, v in spans.items() if k.startswith("fitpack.trips."))
    if not fits or not trips:
        return None
    return trips / fits["n"]
