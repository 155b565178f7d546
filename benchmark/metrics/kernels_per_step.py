"""kernels_per_step.*: kernels launched in the traced window per step."""


def read(ctx):
    return ctx["trace"].kernels / ctx["units"]
