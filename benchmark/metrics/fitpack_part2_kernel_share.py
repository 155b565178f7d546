"""fitpack_part2_kernel_share.*: ops/fitpack.py: the program's counter
`fitpack.part2.launches` (one a launch of the part-2 kernel,
csrc/fitpack_part2.cu) over the calls of its span `stage.fitpack.fit`, in
the traced window: 1.0 where every fit runs its part 2 as one launch. None
where the program has no such counter."""


def read(ctx):
    try:
        from ft_fsd_path_planning_torch.utils.timer import table
    except ImportError:
        return None
    spans = table()
    fits = spans.get("stage.fitpack.fit")
    launches = spans.get("fitpack.part2.launches")
    if not fits or launches is None:
        return None
    return launches / fits["n"]
