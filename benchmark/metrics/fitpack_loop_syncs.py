"""fitpack_loop_syncs.*: the program's ops/fitpack.py::loop_syncs counter over the traced window, per frame or step."""


def read(ctx):
    return ctx["loop_syncs"] / ctx["units"]
