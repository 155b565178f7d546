"""kernels_per_frame.*: kernels launched in the traced window per frame."""


def read(ctx):
    return ctx["trace"].kernels / ctx["units"]
