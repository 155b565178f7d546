"""b2_kernel_share.*: models/sorting.py: the program's counter
`sorting.b2.launches` (one a launch of kernel B2, csrc/beam_search.cu) over
the calls of its span `stage.sorting.run`, in the traced window. A call of
the sorter searches both sides of every frame in one launch, so this reads
1.0 where the sorter runs B2, and falls where it runs the scan, which
counts nothing. None where the program has no such span."""


def read(ctx):
    try:
        from ft_fsd_path_planning_torch.utils.timer import table
    except ImportError:
        return None
    spans = table()
    sorts = spans.get("stage.sorting.run")
    if not sorts:
        return None
    return spans.get("sorting.b2.launches", 0) / sorts["n"]
