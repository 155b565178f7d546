"""facade_host_ms.*: models/facade.py: the facade's own host ms a frame, the
program's span `stage.facade.call` less `stage.facade.step`, over the traced
window. None where the program has no such spans.

Read over the traced window, which runs under `torch.profiler`: the
profiler's own cost a host op is inside these times, so they read above
the host time of an untraced frame."""


def read(ctx):
    try:
        from ft_fsd_path_planning_torch.utils.timer import table
    except ImportError:
        return None
    spans = table()
    call, step = spans.get("stage.facade.call"), spans.get("stage.facade.step")
    if not call or not step:
        return None
    return (call["ns"] - step["ns"]) / 1e6 / ctx["units"]
