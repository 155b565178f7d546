"""b1_solves_per_frame.*: launches of kernel B1 a frame in the traced window,
as the launch probe counts them (`harness/probes.py::Launches`): one a
solve the spline engine asks for (`ops/spline.py::_solve_spd_banded`).
None where the run took no launch probe."""


def read(ctx):
    launches = ctx.get("launches")
    if launches is None:
        return None
    return launches.count["B1"] / ctx["units"]
