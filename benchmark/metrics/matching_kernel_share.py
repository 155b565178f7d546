"""matching_kernel_share.*: models/matching.py: the program's counter
`matching.kernel.launches` (one a launch of the matching kernel,
csrc/cone_matching.cu) over the calls of its span `stage.matching.run`, in
the traced window. A call matches every lane of its batch in one launch, so
this reads 1.0 where every call launches the kernel, and 0.0 where the
plain version runs (the CPU). None where the program has no such span or no
matching kernel."""


def read(ctx):
    try:
        from ft_fsd_path_planning_torch.models import matching
        from ft_fsd_path_planning_torch.utils.timer import table
    except ImportError:
        return None
    if not hasattr(matching, "run_cone_matching_cuda"):
        return None
    spans = table()
    calls = spans.get("stage.matching.run")
    if not calls:
        return None
    return spans.get("matching.kernel.launches", 0) / calls["n"]
