"""The fit kernel (csrc/fitpack_part2.cu) held against its plain version
lane by lane: the one comparison that chip_smoke.py and
tests/test_torch_fitpack_card.py make, with its limits. Imports no JAX, so
it runs on the card's machine.

:func:`compare_fits` launches the kernel's entry ``fitpack_fit_f32`` and runs
``ops/fitpack.py::fitpack_parts12_plain`` on the same iteration 0, and
:func:`judge_fits` sorts the lanes. A tiny lane (4 live sites or fewer)
takes the closed form on both sides, with no knot, within PART2_REL_TOL. On
every other lane:

* the knots (bit for bit: a knot is a data site) and ``budget_hit`` must be
  the plain version's. A lane whose knots part ways is excused as a near-tie,
  and reported, only where the first of the plain side's decisions that the
  kernel's knots contradict (:func:`divergence`) came within NEAR_TIE of a
  tie; else it is a fault;
* with the same knots and the same part-2 trips, both sides converge
  (|fp - s| < acc) or both stop unconverged (the monotonicity stop,
  FITPACK's ier = 2, or MAXIT trips), and the kernel's coefficients lie
  within PART2_REL_TOL of the lane's largest; a lane on which one side
  converges and the other does not is a fault;
* with the same knots and other part-2 trips (a trial at the threshold, or
  a float32 factorisation that breaks down on one side only), both sides
  converge or both stop unconverged, or it is a fault; such lanes are
  reported, and chip_smoke.py holds their share of a drive below
  DIFFER_SHARE.

The plain side's lanes whose p-iteration retried a trial that was not
finite are counted, with those the kernel matched trip for trip: the
kernel's step after a breakdown (``too_small_p``) is held there.

The inputs it builds besides the program's own calls: the trackdrive
witness (:func:`witness`), whose p-iteration steps back inside its bracket;
noisy copies of the acceleration hairpin's fit (:func:`hairpin_copies`), on
which part 2's small-p trials break down; and, for the plain part 2 on the
CPU, lanes whose knots close in on each other (:func:`clustered_knots`,
:func:`broken_trials`).

The two sides differ in the order of their sums and in part 2's initial p
(the kernel takes B1's factor of G), nothing else.
"""

from __future__ import annotations

import dataclasses

import torch

from ft_fsd_path_planning_torch.ops import fitpack

#: max |kernel - plain| over the coefficients of a lane with the same trips on
#: both sides, relative to its largest
PART2_REL_TOL = 1e-4

#: a lane whose knots part ways from its plain version's is a near-tie, and
#: reported, where the plain side's decision at which they part
#: (:func:`divergence`) lay within this share of the quantities it compared
#: (two intervals' fpint, fp against s + acc, nplus's quotient against a
#: whole number); else a fault
NEAR_TIE = 1e-3

#: the most of a drive's lanes whose part-2 trips may differ between the
#: kernel and the plain version (both sides converged or both stopped): the
#: acceleration session, whose hairpin fits run the most part-2 trips, reads
#: 16 of 180, the other drives below 1%
DIFFER_SHARE = 0.125

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
    """The arguments of every plain part 2 (``fitpack_part2_plain``) that
    ``run()`` makes: on the CPU one a fit; on the card a fit runs part 2
    inside the fit kernel."""
    seen = []
    original = fitpack.fitpack_part2_plain

    def recording(*args):
        seen.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return original(*args)

    fitpack.fitpack_part2_plain = recording
    try:
        run()
    finally:
        fitpack.fitpack_part2_plain = original
    return seen


def witness_fit_inputs(device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """(points (1, 64, 2), mask (1, 64)) of the witness fit, as the program
    pads it."""
    points = torch.zeros((1, WITNESS_SITES, 2), dtype=torch.float32)
    points[0, : len(WITNESS_POINTS)] = torch.tensor(WITNESS_POINTS, dtype=torch.float32)
    mask = torch.arange(WITNESS_SITES)[None] < len(WITNESS_POINTS)
    return points.to(device), mask.to(device)


def witness(device="cpu") -> tuple:
    """The plain version's part-2 call of the witness fit."""
    points, mask = witness_fit_inputs(device)
    return part2_of(fit_inputs(points, mask, WITNESS_S))


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


def plain_with_retries(args, part2=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain part 2's (coefficients, trips) on ``args`` and, a lane,
    whether one of its trials was not finite, so that the p-iteration
    retried. A lane whose loop has ended solves its last, finite system
    again, so a non-finite solve of a lane that is not gated is always a
    retry. ``part2`` is the plain part 2 to run (``fitpack_part2_plain``)."""
    part2 = part2 or fitpack.fitpack_part2_plain
    broke = torch.zeros(args[2].shape[0], dtype=torch.bool, device=args[2].device)
    original = fitpack._solve_spd_banded

    def recording(a, rhs):
        nonlocal broke
        x = original(a, rhs)
        broke = broke | ~torch.isfinite(x).flatten(1).all(dim=1)
        return x

    fitpack._solve_spd_banded = recording
    try:
        coef, trips = part2(*args)
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


#: the acceleration session's frame whose 704-site fit (the hairpin) makes
#: the plain version's part 2 retry a trial that broke down
HAIRPIN_FRAME = 11


def hairpin_copies(args, batch: int = 256, noise: float = 1e-3, seed: int = 0) -> tuple:
    """The ``fitpack_parts12`` call of ``batch`` copies of the one-lane fit
    ``args`` (the acceleration hairpin's, HAIRPIN_FRAME), each site moved by
    seeded noise of ``noise`` m a coordinate. A float32 factorisation of
    part 2's small-p trials breaks down on some copies and not on others (on
    the CPU about half of them retry), so the kernel's step after a
    breakdown is compared through the fit entry."""
    points, mask, s = args[1], args[2], args[7]
    if points.shape[0] != 1:
        raise ValueError("hairpin_copies takes a one-lane fit")
    gen = torch.Generator().manual_seed(seed)
    shake = torch.randn((batch, *points.shape[1:]), generator=gen) * noise
    copies = (points.cpu() + shake * mask.cpu()[..., None]).to(points.device)
    return fit_inputs(copies, mask.repeat(batch, 1), s)


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


# --- whole fits: parts 1 and 2 -------------------------------------------


def capture_fits(run) -> list[tuple]:
    """The arguments of every ``fitpack_parts12`` call that ``run()`` makes:
    what a fit hands on after its eager iteration 0."""
    seen = []
    original = fitpack.fitpack_parts12

    def recording(*args):
        seen.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return original(*args)

    fitpack.fitpack_parts12 = recording
    try:
        run()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        fitpack.fitpack_parts12 = original
    return seen




def plain_parts12(args) -> tuple[tuple, torch.Tensor]:
    """The plain version of the fits ``args`` from their iteration 0
    (``fitpack_parts12_plain``, on any device) and, a lane, whether its
    part 2 retried a trial that was not finite (:func:`plain_with_retries`)."""
    retried = []
    original = fitpack.fitpack_part2_plain

    def recording(*part2_args):
        coef, trips, broke = plain_with_retries(part2_args, original)
        retried.append(broke)
        return coef, trips

    fitpack.fitpack_part2_plain = recording
    try:
        out = fitpack.fitpack_parts12_plain(*args)
    finally:
        fitpack.fitpack_part2_plain = original
    return out, retried[0]


def part2_of(args) -> tuple:
    """The part-2 call the plain version makes on the fits ``args``."""
    (call,) = capture(lambda: fitpack.fitpack_parts12_plain(*args))
    return call


def fit_inputs(points: torch.Tensor, mask: torch.Tensor, s: float) -> tuple:
    """The ``fitpack_parts12`` arguments of the fit of ``points``, ``mask``."""
    (args,) = capture_fits(lambda: fitpack.fitpack_fit(points, mask, s))
    return args


def lane(args, i: int) -> tuple:
    return tuple(a[i : i + 1] if isinstance(a, torch.Tensor) else a for a in args)


def _knots(t: torch.Tensor, n) -> list[float]:
    return t.reshape(-1)[: int(n)].tolist()


def divergence(args, t_kernel: torch.Tensor, n_kernel: int) -> tuple[str, float] | None:
    """On a one-lane fit, the first of part 1's decisions on the plain side
    that the kernel's final knots ``t_kernel[:n_kernel]`` contradict, and how
    near that decision came to a tie, as a share of what it compared; None
    where the plain side places those knots.

    Part 1 only ever adds knots, so the kernel's final set holds every knot
    it inserted. The plain side parts ways at an insertion whose knot the
    kernel does not hold: the choice of interval (``fpint``: best against
    second over best), or the decision to insert at all (before a round's
    first insertion the done test, |fp - (s + acc)| over fp; before a later
    one nplus's count, the distance of its quotient to a whole number). Or
    the kernel went on where the plain side stopped, at the end of a round
    (nplus's count) or at the done test that ended part 1: there the knot
    the plain side would have inserted next is one that the kernel holds and
    the plain side never places. Where neither shows, the decision is not
    found and its margin is inf (never excused)."""
    u, points, mask, u_max, c0, fp0, resid0, s, acc = args
    kernel = set(_knots(t_kernel, n_kernel))
    events = []
    insert, stats, solve = fitpack._insert_knot, fitpack._interval_stats, fitpack._lsq_solve

    def recording_stats(x, m, resid, t_int, n_int, endpoint_mask):
        fpint, nrdata = stats(x, m, resid, t_int, n_int, endpoint_mask)
        events.append(("stats", (x, m, t_int, n_int, fpint, nrdata, endpoint_mask)))
        return fpint, nrdata

    def recording_insert(x, m, t_int, n_int, fpint, nrdata, endpoint_mask):
        out = insert(x, m, t_int, n_int, fpint, nrdata, endpoint_mask)
        can = (nrdata[0] > 0) & (torch.arange(fitpack.NI, device=x.device) <= n_int[0])
        score = torch.sort(fpint[0][can], descending=True).values
        tie = float((score[0] - score[1]) / score[0]) if score.numel() >= 2 and float(score[0]) > 0 else float("inf")
        events.append(("insert", (x, m, *out, endpoint_mask), _new_knot(t_int, n_int, out[0], out[1]), tie))
        return out

    def recording_solve(b, y, m, n_int):
        c, fp, resid = solve(b, y, m, n_int)
        events.append(("solve", float(fp[0]), int(n_int[0])))
        return c, fp, resid

    fitpack._insert_knot, fitpack._interval_stats, fitpack._lsq_solve = recording_insert, recording_stats, recording_solve
    try:
        t_plain, n_plain, *_ = fitpack.fitpack_parts12_plain(*args)
    finally:
        fitpack._insert_knot, fitpack._interval_stats, fitpack._lsq_solve = insert, stats, solve
    plain = set(_knots(t_plain, n_plain[0]))
    if plain == kernel:
        return None
    only_kernel = kernel - plain

    def next_knot(state):
        out = insert(*state)
        return _new_knot(state[2], state[3], out[0], out[1])

    # rounds: (fp tested, knots before the round, stats of the round, its insertions);
    # round 0 tests the polynomial's fp0 and inserts once (nplus = 1)
    rounds, fp, count = [], float(fp0[0]), 0
    for event in events:
        if event[0] == "solve":
            fp, count = event[1], event[2]
        elif event[0] == "stats":
            rounds.append([fp, count, event[1], []])
        else:
            rounds[-1][3].append(event)
    fps = [r[0] for r in rounds]
    quotients, nplus = [float("inf")], 1
    for k in range(1, len(rounds)):
        delta, fpms = fps[k - 1] - fps[k], fps[k] - s
        quotient = float("inf")
        if delta > acc:
            ratio = nplus * fpms / delta
            quotient = abs(ratio - round(ratio)) / max(abs(ratio), 1.0)
            npl1 = int(ratio)
        else:
            npl1 = nplus * 2
        nplus = 1 if rounds[k][1] == 0 else min(nplus * 2, max(npl1, nplus // 2, 1))
        quotients.append(quotient)
    # where the kernel went on: the first stop whose next knot it holds, and
    # every later stop with that same next knot and no plain insertion
    # between that it lacks (the knots cannot tell these apart: the least
    # margin of them counts)
    went_on, extra = [], None

    def stop(knot, what, margin):
        nonlocal extra
        if knot in only_kernel and extra in (None, knot):
            extra = knot
            went_on.append((f"{what}: the kernel went on to knot {knot!r}", margin))

    for k, (fp, _, state, inserts) in enumerate(rounds):
        done = abs(fp - (s + acc)) / max(abs(fp), 1e-30)
        if k == len(rounds) - 1:
            # part 1 ended here (the first insertion of round 0 is computed
            # and dropped where fp0 is done)
            stop(next_knot(state), f"the done test after round {k} (fp {fp!r})", done)
            break
        for j, (_, out, knot, tie) in enumerate(inserts):
            if knot not in kernel:
                if went_on:
                    break
                decided = done if j == 0 else quotients[k]
                return f"insertion {j + 1} of round {k}, knot {knot!r}: the kernel does not hold it", min(tie, decided)
        else:
            if inserts:
                stop(next_knot(inserts[-1][1]), f"the count of round {k} ({len(inserts)} insertions)", quotients[k])
            continue
        break
    if went_on:
        return "; or ".join(w for w, _ in went_on), min(m for _, m in went_on)
    return "not found", float("inf")


def _new_knot(t_before, n_before, t_after, n_after) -> float | None:
    """The knot that an insertion added, None where it added none."""
    old = set(_knots(t_before, n_before[0]))
    new = [v for v in _knots(t_after, n_after[0]) if v not in old]
    return new[0] if new else None


@dataclasses.dataclass
class FitComparison:
    """What :func:`judge_fits` found over one or more calls."""

    calls: int = 0
    lanes: int = 0
    tiny: int = 0  # 4 live sites or fewer: the closed form
    same_knots: int = 0
    lsq: int = 0  # same knots, part 2 gated on both sides: the least-squares spline
    converged: int = 0  # same knots, same part-2 trips, both converged
    stopped: int = 0  # same knots, same part-2 trips, both stopped unconverged
    retried: int = 0  # same knots, the plain side's part 2 retried a non-finite trial
    retried_same_trips: int = 0  # of those, with the kernel's part-2 trips
    worst_tiny: float = 0.0
    worst_lsq: float = 0.0
    worst_converged: float = 0.0
    worst_stopped: float = 0.0
    trips_kernel: tuple = (0, 0)  # part 1's solves, part 2's trips, summed over lanes
    trips_plain: tuple = (0, 0)
    near_ties: list = dataclasses.field(default_factory=list)  # lanes whose knots part ways on a near-tie
    differ: list = dataclasses.field(default_factory=list)  # same knots, other part-2 trips
    faults: list = dataclasses.field(default_factory=list)

    def summary(self) -> str:
        return (
            f"{self.calls} calls, {self.lanes} lanes: tiny {self.tiny}, max |kernel - plain| / max |plain| "
            f"{self.worst_tiny!r}; the same knots and budget_hit {self.same_knots} (least-squares spline "
            f"{self.lsq} {self.worst_lsq!r}; same part-2 trips and both converged {self.converged} "
            f"{self.worst_converged!r}, both stopped unconverged {self.stopped} {self.worst_stopped!r}; limit "
            f"{PART2_REL_TOL!r}); plain part 2 retried a non-finite trial on {self.retried} ({self.retried_same_trips} "
            f"with the kernel's trips); lanes whose knots part ways on a near-tie {len(self.near_ties)}; lanes whose "
            f"part-2 trips differ {len(self.differ)} (share {self.differ_share()!r}, limit {DIFFER_SHARE!r}); trips "
            f"(part 1, part 2) kernel {self.trips_kernel} plain {self.trips_plain}"
        )

    def differ_share(self) -> float:
        return len(self.differ) / max(self.lanes, 1)


def judge_fits(args, got: tuple, want: tuple, retried: torch.Tensor, result: FitComparison | None = None,
               label: str = "") -> FitComparison:
    """Sort the lanes of the fits ``args`` (one ``fitpack_parts12`` call) by
    what the kernel's results ``got`` and the plain version's ``want`` (each
    (t_int, n_int, coef, budget_hit, trips)) show, with the plain side's
    retried lanes, and add them to ``result``."""
    r = result if result is not None else FitComparison()
    where = f"{label} call {r.calls}"
    t_g, n_g, c_g, b_g, tr_g = got
    t_w, n_w, c_w, b_w, tr_w = want
    u, points, mask, u_max, s, acc = args[0], args[1], args[2], args[3], args[7], args[8]
    r.calls += 1
    r.lanes += mask.shape[0]
    r.trips_kernel = tuple(a + int(b) for a, b in zip(r.trips_kernel, tr_g.sum(dim=0)))
    r.trips_plain = tuple(a + int(b) for a, b in zip(r.trips_plain, tr_w.sum(dim=0)))
    if not bool(torch.isfinite(c_g).all()):
        r.faults.append(f"{where}: non-finite coefficients")
    err = (c_g - c_w).abs().amax(dim=(1, 2)) / c_w.abs().amax(dim=(1, 2)).clamp(min=1e-30)
    tiny = mask.sum(dim=1) <= 4
    same = torch.all(t_g == t_w, dim=1) & (n_g == n_w)
    f_g = lane_fp((u, points, mask, t_g, n_g, u_max), c_g) - s
    f_w = lane_fp((u, points, mask, t_w, n_w, u_max), c_w) - s
    # one read of what the lanes show
    err, tiny, same, f_g, f_w, retried = (a.cpu() for a in (err, tiny, same, f_g, f_w, retried))
    t_g, n_g, b_g, tr_g, n_w, b_w, tr_w = (a.cpu() for a in (t_g, n_g, b_g, tr_g, n_w, b_w, tr_w))
    for i in range(mask.shape[0]):
        e = float(err[i])
        if bool(tiny[i]):
            r.tiny += 1
            r.worst_tiny = max(r.worst_tiny, e)
            if not (bool(same[i]) and int(n_g[i]) == 0 and not bool(b_g[i])) or e > PART2_REL_TOL:
                r.faults.append(f"{where} lane {i}: a tiny lane is off its plain version by {e!r}")
            continue
        if not bool(same[i]):
            found = divergence(lane(args, i), t_g[i], int(n_g[i]))
            decision, margin = found if found is not None else ("none: the same set in another order", float("inf"))
            line = (
                f"{where} lane {i}: knots part ways, n_int kernel {int(n_g[i])} plain {int(n_w[i])}, part-1 solves "
                f"kernel {int(tr_g[i, 0])} plain {int(tr_w[i, 0])}, at {decision}, margin {margin!r} "
                f"(near-tie below {NEAR_TIE!r})"
            )
            (r.near_ties if margin <= NEAR_TIE else r.faults).append(line)
            continue
        r.same_knots += 1
        if bool(b_g[i]) != bool(b_w[i]) or int(tr_g[i, 0]) != int(tr_w[i, 0]):
            r.faults.append(
                f"{where} lane {i}: the same knots, but budget_hit {bool(b_g[i])}/{bool(b_w[i])} or part-1 "
                f"solves {int(tr_g[i, 0])}/{int(tr_w[i, 0])} differ"
            )
        conv_g, conv_w = abs(float(f_g[i])) < acc, abs(float(f_w[i])) < acc
        same_trips = int(tr_g[i, 1]) == int(tr_w[i, 1])
        r.retried += int(retried[i])
        r.retried_same_trips += int(bool(retried[i]) and same_trips)
        if not same_trips:
            line = (
                f"{where} lane {i}: part-2 trips kernel {int(tr_g[i, 1])} plain {int(tr_w[i, 1])}, |fp - s| kernel "
                f"{abs(float(f_g[i]))!r} plain {abs(float(f_w[i]))!r} against acc {acc!r}, relative coefficient "
                f"error {e!r}{', the plain version retried' if bool(retried[i]) else ''}"
            )
            r.differ.append(line)
            if conv_g != conv_w:
                r.faults.append(f"{line}: only one side converges")
            continue
        if int(tr_w[i, 1]) == 0:
            cls = "lsq"
        elif conv_g != conv_w:
            r.faults.append(
                f"{where} lane {i}: the same part-2 trips ({int(tr_w[i, 1])}), but only one side converges: |fp - s| "
                f"kernel {abs(float(f_g[i]))!r} plain {abs(float(f_w[i]))!r} against acc {acc!r}"
            )
            continue
        else:
            cls = "converged" if conv_w else "stopped"
        setattr(r, cls, getattr(r, cls) + 1)
        setattr(r, f"worst_{cls}", max(getattr(r, f"worst_{cls}"), e))
        if e > PART2_REL_TOL:
            r.faults.append(f"{where} lane {i}: a {cls} lane is off its plain version by {e!r} (limit {PART2_REL_TOL!r})")
    return r


def compare_fits(args, result: FitComparison | None = None, label: str = "") -> FitComparison:
    """Launch the fit kernel and run the plain version on ``args`` (one
    ``fitpack_parts12`` call on CUDA tensors) and add what the lanes show to
    ``result`` (:func:`judge_fits`)."""
    got = fitpack.fitpack_parts12_cuda(*args)
    want, retried = plain_parts12(args)
    return judge_fits(args, got, want, retried, result, label)
