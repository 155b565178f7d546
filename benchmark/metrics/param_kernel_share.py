"""param_kernel_share.*: models/pathing.py: the program's counter
`pathing.param_kernel.launches` (one a launch of the parameterization
kernel, csrc/path_parameterize.cu) over the calls of its span
`stage.pathing.param_tail`, in the traced window. A call parameterizes
every lane of its batch in one launch, so this reads 1.0 where every call
launches the kernel, and 0.0 where the plain version runs (the CPU). None
where the program has no such span or no parameterization kernel."""


def read(ctx):
    try:
        from ft_fsd_path_planning_torch.models import pathing
        from ft_fsd_path_planning_torch.utils.timer import table
    except ImportError:
        return None
    if not hasattr(pathing, "parameterize_tail_cuda"):
        return None
    spans = table()
    calls = spans.get("stage.pathing.param_tail")
    if not calls:
        return None
    return spans.get("pathing.param_kernel.launches", 0) / calls["n"]
