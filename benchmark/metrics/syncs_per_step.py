"""syncs_per_step.*: synchronising CUDA runtime calls in the traced window per step."""


def read(ctx):
    return ctx["trace"].syncs / ctx["units"]
