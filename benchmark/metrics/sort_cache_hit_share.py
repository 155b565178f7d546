"""sort_cache_hit_share.*: models/facade.py: the program's counter
`facade.sort_cache.hits` (one a frame that reuses the cached sorted order
and skips the sorter) over its counter `facade.sort_cache.lookups` (one a
frame the facade runs with the sorting-result cache on), in the traced
window. None where the program has no such counters."""


def read(ctx):
    try:
        from ft_fsd_path_planning_torch.utils.timer import table
    except ImportError:
        return None
    counts = table()
    lookups = counts.get("facade.sort_cache.lookups")
    if not lookups:
        return None
    return counts.get("facade.sort_cache.hits", 0) / lookups
