"""sort_cache_host_ms.*: models/facade.py: host ms a frame in the program's
span `stage.facade.sort_cache` (the cache's lookup: the start cones and
their fetch, the three similarity tests, and on a hit the remap and the
upload of the cached order) over the traced window. None where the program
has no such span.

Read over the traced window, which runs under `torch.profiler`: the
profiler's own cost a host op is inside these times, so they read above
the host time of an untraced frame."""


def read(ctx):
    try:
        from ft_fsd_path_planning_torch.utils.timer import table
    except ImportError:
        return None
    lookup = table().get("stage.facade.sort_cache")
    if not lookup:
        return None
    return lookup["ns"] / 1e6 / ctx["units"]
