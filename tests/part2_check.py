"""The part-2 kernel (csrc/fitpack_part2.cu) held against its plain version
(ops/fitpack.py::fitpack_part2_plain) lane by lane: the one comparison that
chip_smoke.py and tests/test_torch_fitpack_card.py make, with its limits.
Imports no JAX, so it runs on the card's machine.

Each lane falls in one class:

* gated (no interior knot, or the least-squares spline already within acc
  of s): both sides return c_lsq bit for bit and make no trip;
* the same trips on both sides: both converge (|fp - s| < acc) or both
  stop unconverged (the monotonicity stop, FITPACK's ier = 2, or MAXIT
  trips), the kernel's coefficients within PART2_REL_TOL of the lane's
  largest (counted and reported apart, under the one limit);
* other trips on the two sides: a trial that sits at the threshold, or a
  float32 factorisation that breaks down on one side only. These lanes are
  reported, with |fp - s| against acc on both sides.

The inputs it builds besides the program's own calls: the trackdrive
witness (:func:`witness`), whose p-iteration steps back inside its bracket,
and lanes whose knots close in on each other (:func:`clustered_knots`,
:func:`broken_trials`), whose small-p trials break down.

The two differ in the order of their sums and in the initial p (the kernel
takes B1's factor of G), nothing else.
"""

from __future__ import annotations

import dataclasses

import torch

from ft_fsd_path_planning_torch.ops import fitpack

#: max |kernel - plain| over the coefficients of a lane with the same trips on
#: both sides, relative to its largest
PART2_REL_TOL = 1e-4

#: the centerline fit of frame 22 of a trackdrive-fsg lap (the benchmark's
#: trackdrive.laps, seed 3100000006): 12 points, s = 0.2. Its p-iteration
#: takes branch 2 (p too small) after p3 is set, and 25 p lies beyond p3; a
#: step left outside the bracket stopped it at fp = 0.1288 (FITPACK's ier =
#: 2, 19.8 mm off the reference's path), the step back inside the bracket
#: converges to fp = 0.20014, as SciPy's splprep does
WITNESS_POINTS = (
    (27.846450805664062, 27.085050582885742), (25.45254898071289, 29.693950653076172),
    (22.70775032043457, 31.78744888305664), (19.551651000976562, 33.33380126953125),
    (16.144699096679688, 34.324546813964844), (12.691949844360352, 34.74970245361328),
    (9.18019962310791, 34.7447509765625), (5.698299884796143, 34.3119010925293),
    (2.238999843597412, 33.664100646972656), (-1.1662499904632568, 32.87525177001953),
    (-4.580349922180176, 32.1556510925293), (-8.030399322509766, 31.44335174560547),
)
WITNESS_S = 0.2
#: the sites of the program's centerline fit (pathing's 64-row buffer)
WITNESS_SITES = 64


def capture(run) -> list[tuple]:
    """The arguments of every part 2 that ``run()`` makes."""
    seen = []
    original = fitpack.fitpack_part2

    def recording(*args):
        seen.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return original(*args)

    fitpack.fitpack_part2 = recording
    try:
        run()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        fitpack.fitpack_part2 = original
    return seen


def witness_fit_inputs(device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """(points (1, 64, 2), mask (1, 64)) of the witness fit, as the program
    pads it."""
    points = torch.zeros((1, WITNESS_SITES, 2), dtype=torch.float32)
    points[0, : len(WITNESS_POINTS)] = torch.tensor(WITNESS_POINTS, dtype=torch.float32)
    mask = torch.arange(WITNESS_SITES)[None] < len(WITNESS_POINTS)
    return points.to(device), mask.to(device)


def witness(device="cpu") -> tuple:
    """The part-2 call of the witness fit."""
    points, mask = witness_fit_inputs(device)
    (args,) = capture(lambda: fitpack.fitpack_fit(points, mask, WITNESS_S))
    return args


def witness_scipy():
    """SciPy's splprep on the witness points, float64: (tck, u, fp, ier)."""
    import numpy as np
    from scipy.interpolate import splprep

    x = np.asarray(WITNESS_POINTS, dtype=np.float64)
    u = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(x, axis=0), axis=1))])
    (tck, _), fp, ier, _ = splprep([x[:, 0], x[:, 1]], u=u, s=WITNESS_S, k=3, full_output=True)
    return tck, u, fp, ier


def lane_fp(args, coef: torch.Tensor) -> torch.Tensor:
    """Each lane's SSR over its live sites for the coefficients ``coef``."""
    u, points, mask, t_int, n_int, u_max = args[:6]
    b = fitpack._design(u, mask, fitpack._full_knots(t_int, n_int, u_max), n_int)
    return ((b @ coef - points) ** 2).sum(dim=2).mul(mask).sum(dim=1)


def fit_fp(fit: fitpack.FpSpline, points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Each lane's SSR over its live sites for the fitted spline ``fit``."""
    u, _, _ = fitpack.chord_lengths(points, mask)
    return lane_fp((u, points, mask, fit.t_int, fit.n_int, fit.u_max), fit.coef)


def plain_with_retries(args) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version's (coefficients, trips) and, a lane, whether one of
    its trials was not finite, so that the p-iteration retried. A lane whose
    loop has ended solves its last, finite system again, so a non-finite
    solve of a lane that is not gated is always a retry."""
    broke = torch.zeros(args[2].shape[0], dtype=torch.bool, device=args[2].device)
    original = fitpack._solve_spd_banded

    def recording(a, rhs):
        nonlocal broke
        x = original(a, rhs)
        broke = broke | ~torch.isfinite(x).flatten(1).all(dim=1)
        return x

    fitpack._solve_spd_banded = recording
    try:
        coef, trips = fitpack.fitpack_part2_plain(*args)
    finally:
        fitpack._solve_spd_banded = original
    return coef, trips, broke & (trips > 0)


def clustered_knots(args, batch: int = 256) -> tuple:
    """A part 2 of ``batch`` lanes built from the one-lane call ``args``
    (at least two interior knots): lane i moves the middle interior knot
    towards its left neighbour, to a gap of 10**-1 down to 10**-2.5 of the
    old one, with the least-squares spline and its SSR worked out anew on
    those knots. The closer two knots, the larger FITPACK's discontinuity
    penalty D^T D against G, so the p-iteration's small-p trials break a
    float32 factorisation down (as on the acceleration hairpin) and retry.
    Closer still (below about 10**-2.7 on acceleration frame 0's fit) the
    systems are so ill-conditioned that any two orders of float32 sums part
    ways, in trips and by up to a quarter of the coefficients."""
    u, points, mask, t_int, n_int, u_max, _, fp0, _, s, acc = args
    n = int(n_int[0])
    if args[2].shape[0] != 1 or n < 2:
        raise ValueError("clustered_knots takes a one-lane call with at least two interior knots")
    k = n // 2
    gaps = torch.logspace(-1.0, -2.5, batch, dtype=t_int.dtype, device=t_int.device)
    t = t_int.repeat(batch, 1)
    t[:, k] = t_int[0, k - 1] + (t_int[0, k] - t_int[0, k - 1]) * gaps
    u, points, mask, n_int, u_max, fp0 = (a.repeat(batch, *([1] * (a.dim() - 1))) for a in (u, points, mask, n_int, u_max, fp0))
    b = fitpack._design(u, mask, fitpack._full_knots(t, n_int, u_max), n_int)
    c_lsq, fp_lsq, _ = fitpack._lsq_solve(b, points, mask, n_int)
    return u, points, mask, t, n_int, u_max, c_lsq, fp0, fp_lsq, s, acc


def broken_trials(args, batch: int = 256) -> tuple:
    """The lanes of :func:`clustered_knots` on which a trial of the plain
    version's p-iteration is not finite (its float32 factorisation breaks
    down) and the lane takes branch 2's step with its bracket kept."""
    clustered = clustered_knots(args, batch)
    _, _, retried = plain_with_retries(clustered)
    if not bool(retried.any()):
        raise ValueError("no lane of the clustered set breaks down")
    keep = torch.nonzero(retried).flatten()
    return tuple(a[keep] if isinstance(a, torch.Tensor) else a for a in clustered)


@dataclasses.dataclass
class Part2Comparison:
    """What :func:`compare` found over one or more calls."""

    calls: int = 0
    lanes: int = 0
    gated: int = 0
    converged: int = 0  # same trips, converged
    stopped: int = 0  # same trips, stopped unconverged
    at_maxit: int = 0  # of those, after MAXIT trips
    retried: int = 0  # lanes on which the plain version retried a non-finite trial
    retried_same_trips: int = 0
    worst_converged: float = 0.0
    worst_stopped: float = 0.0
    trips_kernel: int = 0
    trips_plain: int = 0
    differ: list = dataclasses.field(default_factory=list)  # lanes whose trips differ
    faults: list = dataclasses.field(default_factory=list)

    def summary(self) -> str:
        return (
            f"{self.calls} calls, {self.lanes} lanes: gated {self.gated} (c_lsq on both sides, bit for bit); "
            f"same trips and converged {self.converged}, max |kernel - plain| / max |plain| {self.worst_converged!r} "
            f"(limit {PART2_REL_TOL!r}); same trips and stopped unconverged {self.stopped} ({self.at_maxit} after "
            f"{fitpack.MAXIT} trips), max {self.worst_stopped!r} (the same limit); lanes on which the "
            f"plain version retried a non-finite trial {self.retried} ({self.retried_same_trips} with the kernel's "
            f"trips); trips kernel {self.trips_kernel} plain {self.trips_plain}; lanes whose trips differ {len(self.differ)}"
        )


def compare(args, result: Part2Comparison | None = None, label: str = "") -> Part2Comparison:
    """Launch the kernel and run the plain version on ``args`` (one part-2
    call on CUDA tensors) and add what the lanes show to ``result``."""
    r = result if result is not None else Part2Comparison()
    i = r.calls
    got, got_trips = fitpack.fitpack_part2_cuda(*args)
    want, want_trips, retried = plain_with_retries(args)
    n_int, c_lsq, fp_lsq, s, acc = args[4], args[6], args[8], args[9], args[10]
    where = f"{label} call {i}"
    r.calls += 1
    r.lanes += got.shape[0]
    r.trips_kernel += int(got_trips.sum())
    r.trips_plain += int(want_trips.sum())
    if not bool(torch.isfinite(got).all()):
        r.faults.append(f"{where}: non-finite coefficients")

    gated = (n_int == 0) | ((fp_lsq - s).abs() < acc)
    r.gated += int(gated.sum())
    for name, coef, trips in (("kernel", got, got_trips), ("plain version", want, want_trips)):
        if not (torch.equal(coef[gated], c_lsq[gated]) and bool((trips[gated] == 0).all())):
            r.faults.append(f"{where}: the {name} does not return c_lsq with 0 trips on a gated lane")

    err = (got - want).abs().amax(dim=(1, 2)) / want.abs().amax(dim=(1, 2)).clamp(min=1e-30)
    f_got, f_want = lane_fp(args, got) - s, lane_fp(args, want) - s
    conv_got, conv_want = f_got.abs() < acc, f_want.abs() < acc
    same = ~gated & (got_trips == want_trips)
    r.retried += int(retried.sum())
    r.retried_same_trips += int((retried & same).sum())
    for lane in torch.nonzero(same & (conv_got != conv_want)).flatten().tolist():
        r.faults.append(f"{where} lane {lane}: the same trips, but only one side converges")
    for cls, attr, count in ((same & conv_want, "worst_converged", "converged"), (same & ~conv_want, "worst_stopped", "stopped")):
        setattr(r, count, getattr(r, count) + int(cls.sum()))
        if bool(cls.any()):
            worst = float(err[cls].max())
            setattr(r, attr, max(getattr(r, attr), worst))
            if worst > PART2_REL_TOL:
                r.faults.append(f"{where}: a {count} lane is off its plain version by {worst!r} (limit {PART2_REL_TOL!r})")
    r.at_maxit += int((same & ~conv_want & (want_trips == fitpack.MAXIT)).sum())
    for lane in torch.nonzero(~gated & (got_trips != want_trips)).flatten().tolist():
        r.differ.append(
            f"{where} lane {lane}: trips kernel {int(got_trips[lane])} plain {int(want_trips[lane])}, "
            f"|f2| kernel {abs(float(f_got[lane]))!r} plain {abs(float(f_want[lane]))!r} against acc {acc!r}, "
            f"relative coefficient error {float(err[lane])!r}{', the plain version retried' if bool(retried[lane]) else ''}"
        )
    return r
