"""sorting_host_ms.*: models/sorting.py: host ms a frame in the program's
span `stage.sorting.run` over the traced window, with no synchronise added.
None where the program has no such span.

Read over the traced window, which runs under `torch.profiler`: the
profiler's own cost a host op is inside these times, so they read above
the host time of an untraced frame."""


def read(ctx):
    try:
        from ft_fsd_path_planning_torch.utils.timer import table
    except ImportError:
        return None
    run = table().get("stage.sorting.run")
    if not run:
        return None
    return run["ns"] / 1e6 / ctx["units"]
