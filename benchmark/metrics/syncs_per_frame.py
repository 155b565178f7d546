"""syncs_per_frame.*: synchronising CUDA runtime calls in the traced window per frame."""


def read(ctx):
    return ctx["trace"].syncs / ctx["units"]
