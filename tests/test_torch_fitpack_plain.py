"""FITPACK's plain version (the CPU's path of ops/fitpack.py) held bit for bit
to what it computed before parts 1 and 2 became one kernel launch on the
card, and the fit kernel's wrapper and dispatch on the CPU.

`fitpack_fit` solves part 1's iteration 0 eagerly and hands the rest to
`fitpack_parts12`: on a CPU tensor the masked loops of
`fitpack_parts12_plain`, on a CUDA tensor one launch of
csrc/fitpack_part2.cu. The golden file `fitpack_plain_golden.npz` holds the
fits and part-2 calls of FITS as the masked loops computed them when they
were still inline in `fitpack_fit`; it was written by running this module
as a script against that tree, with PyTorch 2.13.0 for the CPU and one
thread:

    python -m tests.test_torch_fitpack_plain   # writes tests/fitpack_plain_golden.npz

Bit for bit holds for that build of torch and that thread count (the
module's fixture sets one thread and restores the count after); another
build may order its sums otherwise.

Also the card check's own logic on the CPU (tests/part2_check.py): its
verdicts on the plain version held to itself and on kernel results made
wrong on purpose, and how it finds where a lane's knots part ways.

Imports no JAX.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from ft_fsd_path_planning_torch.ops import fitpack as tfp
from tests import part2_check
from tests.torch_parity import seeded_traces

GOLDEN = Path(__file__).resolve().with_name("fitpack_plain_golden.npz")

#: seeded fits: (seed, B, M, noise, live sites (lo, hi) or None, s). The
#: first has a tiny lane (3 live sites), the last lanes that stop on the
#: knot budget
FITS = {
    "seeded (8, 64) s=0.2": (11, 8, 64, 0.05, None, 0.2),
    "seeded (8, 256) s=0.01": (12, 8, 256, 0.05, (166, 204), 0.01),
    "seeded (6, 512) s=0.2": (13, 6, 512, 0.05, (25, 89), 0.2),
    "seeded (6, 128) s=0.001 noisy": (14, 6, 128, 0.3, (40, 120), 0.001),
}


def _fit_inputs(case: str):
    seed, bsz, m, noise, live, s = FITS[case]
    pts, mask = seeded_traces(seed, bsz, m, noise, live)
    return torch.tensor(pts), torch.tensor(mask), s


def _fit_arrays(fit: tfp.FpSpline) -> dict:
    return {name: getattr(fit, name).numpy() for name in tfp.FpSpline._fields}


def outputs() -> dict:
    """Every array the golden file holds, by '<case>/<name>'."""
    out = {}
    for case in FITS:
        for name, a in _fit_arrays(tfp.fitpack_fit(*_fit_inputs(case))).items():
            out[f"{case}/{name}"] = a
    points, mask = part2_check.witness_fit_inputs()
    for name, a in _fit_arrays(tfp.fitpack_fit(points, mask, part2_check.WITNESS_S)).items():
        out[f"witness/{name}"] = a
    # part 2 on lanes whose middle knot closes in on its neighbour
    pts, mask, s = _fit_inputs("seeded (6, 512) s=0.2")
    calls = part2_check.capture(lambda: tfp.fitpack_fit(pts[5:6], mask[5:6], s))
    coef, trips = tfp.fitpack_part2_plain(*part2_check.clustered_knots(calls[0], 32))
    out["clustered (32, 512)/coef"], out["clustered (32, 512)/trips"] = coef.numpy(), trips.numpy()
    return out


@pytest.fixture(scope="module")
def now():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return outputs()
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("case", [*FITS, "witness", "clustered (32, 512)"])
def test_plain_path_is_bit_for_bit_what_it_was(case, now):
    golden = np.load(GOLDEN)
    names = [k for k in golden.files if k.startswith(case + "/")]
    assert names
    for key in names:
        a, b = now[key], golden[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(a, b, equal_nan=True), (key, np.abs(a.astype(np.float64) - b).max())


def test_plain_trips_count_each_lanes_solves_and_part2_trips():
    pts, mask, s = _fit_inputs("seeded (8, 64) s=0.2")
    args = _iteration0(pts, mask, s)
    tfp.loop_syncs = 0
    _, n_int, *_, trips = tfp.fitpack_parts12_plain(*args)
    part2 = part2_check.capture(lambda: tfp.fitpack_parts12_plain(*args))
    _, want2 = tfp.fitpack_part2_plain(*part2[0])
    tiny = mask.sum(dim=1) <= 4
    assert trips.dtype == torch.int32 and tuple(trips.shape) == (8, 2)
    assert bool((trips[tiny] == 0).all())
    # a lane with knots solved on them; a lane done at iteration 0 made no trip
    assert torch.equal(trips[~tiny, 0] > 0, n_int[~tiny] > 0) and bool((trips[:, 0] > 0).any())
    assert torch.equal(trips[~tiny, 1], want2[~tiny])
    # one loop check a trip of the slowest lane, and the one that ends the loop
    assert tfp.loop_syncs >= int(trips[:, 0].max()) + 1


def _iteration0(points, mask, s):
    """The arguments fitpack_fit hands fitpack_parts12."""
    seen = []
    original = tfp.fitpack_parts12

    def recording(*args):
        seen.append(args)
        return original(*args)

    tfp.fitpack_parts12 = recording
    try:
        tfp.fitpack_fit(points, mask, s)
    finally:
        tfp.fitpack_parts12 = original
    (args,) = seen
    return args


def test_parts12_dispatch_takes_the_plain_version_on_the_cpu():
    pts, mask, s = _fit_inputs("seeded (8, 64) s=0.2")
    args = _iteration0(pts, mask, s)
    launches = tfp.part2_launch_count
    got = tfp.fitpack_parts12(*args)
    want = tfp.fitpack_parts12_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tfp.part2_launch_count == launches
    fit = tfp.fitpack_fit(pts, mask, s)
    assert all(torch.equal(a, b) for a, b in zip((fit.t_int, fit.n_int, fit.coef, fit.budget_hit), want[:4]))


@pytest.mark.parametrize("fault", ["cpu", "mixed devices", "dtype", "mask dtype", "shape", "sites"])
def test_parts12_cuda_wrapper_refuses_what_the_kernel_does_not_take(fault):
    pts, mask, s = _fit_inputs("seeded (8, 64) s=0.2")
    args = list(_iteration0(pts, mask, s))
    # the wrapper checks devices, dtypes and shapes before it touches the
    # kernel: stand-ins that report a CUDA device reach the checks after
    # the device check without a card
    if fault == "cpu":
        with pytest.raises(ValueError, match="CUDA tensors"):
            tfp.fitpack_parts12_cuda(*args)
        return
    fake = _FakeCuda(args)
    if fault == "mixed devices":
        fake.device_of[1] = torch.device("cuda", 1)
        with pytest.raises(ValueError, match="one device"):
            fake.call()
    elif fault == "dtype":
        fake.args[0] = fake.args[0].double()
        with pytest.raises(TypeError, match="float32"):
            fake.call()
    elif fault == "mask dtype":
        fake.args[2] = fake.args[2].to(torch.uint8)
        with pytest.raises(TypeError, match="bool mask"):
            fake.call()
    elif fault == "shape":
        fake.args[6] = fake.args[6][:, :-1]
        with pytest.raises(ValueError, match="resid0"):
            fake.call()
    else:
        m = tfp.PART2_MAX_SITES + 1
        fake.args[:3] = [torch.zeros(1, m), torch.zeros(1, m, 2), torch.zeros(1, m, dtype=torch.bool)]
        fake.args[3:7] = [torch.zeros(1), torch.zeros(1, tfp.NC, 2), torch.zeros(1), torch.zeros(1, m)]
        with pytest.raises(ValueError, match="sites"):
            fake.call()


class _FakeCuda:
    """Calls fitpack_parts12_cuda on CPU tensors that report a CUDA device
    (``device_of`` overrides one argument's), so that the checks after the
    device check run on a machine without a card."""

    def __init__(self, args):
        self.args = list(args)
        self.device_of = {}

    def call(self):
        cuda = torch.device("cuda", 0)
        wrapped = [
            _Reporting(a, self.device_of.get(i, cuda)) if isinstance(a, torch.Tensor) else a
            for i, a in enumerate(self.args)
        ]
        return tfp.fitpack_parts12_cuda(*wrapped)


class _Reporting:
    """A tensor's device, dtype and shape, under a device it claims."""

    def __init__(self, tensor, device):
        self.device, self.dtype, self.shape = device, tensor.dtype, tensor.shape


# --- the card check's logic (tests/part2_check.py) on the CPU ----------------


def _plain(case: str):
    """(fitpack_parts12 arguments, plain results, retried lanes) of a FITS case."""
    args = _iteration0(*_fit_inputs(case))
    want, retried = part2_check.plain_parts12(args)
    return args, want, retried


def test_judge_holds_the_plain_version_to_itself():
    found = part2_check.FitComparison()
    for case in FITS:
        args, want, retried = _plain(case)
        part2_check.judge_fits(args, want, want, retried, found, case)
    assert not found.faults and not found.differ and not found.near_ties, found.summary()
    assert found.tiny == 1 and found.converged > 0 and found.stopped > 0 and found.lsq > 0
    assert found.same_knots + found.tiny == found.lanes
    assert found.worst_converged == found.worst_stopped == 0.0


def _knot_dropped(got, i):
    """The results ``got`` with lane i's last knot dropped."""
    t, n = got[0].clone(), got[1].clone()
    n[i] -= 1
    t[i, int(n[i])] = tfp._BIG
    return t, n


#: kernel results made wrong on purpose: (FITS case, lane, what is changed,
#: what the check must find)
MUTANTS = {
    "coefficients off, the same trips": ("seeded (6, 512) s=0.2", 0, "coef", "only one side converges"),
    "coefficients off on a stopped lane": ("seeded (8, 256) s=0.01", 2, "coef", "off its plain version"),
    "other part-2 trips, both converge": ("seeded (6, 512) s=0.2", 1, "trips", None),
    "other part-2 trips, both stopped": ("seeded (8, 256) s=0.01", 3, "trips", None),
    "other part-2 trips, only the plain version converges": ("seeded (6, 512) s=0.2", 2, "trips coef", "only one side converges"),
    "budget_hit differs": ("seeded (6, 512) s=0.2", 3, "budget", "budget_hit"),
    "a knot short": ("seeded (6, 512) s=0.2", 4, "knots", "knots part ways"),
}


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_judge_finds_a_kernel_made_wrong(mutant):
    case, i, change, finds = MUTANTS[mutant]
    args, want, retried = _plain(case)
    t, n, c, b, trips = (a.clone() for a in want)
    if "coef" in change:
        c[i] *= 1.01
    if "trips" in change:
        trips[i, 1] += 1
    if change == "budget":
        b[i] = ~b[i]
    if change == "knots":
        t, n = _knot_dropped(want, i)
    found = part2_check.judge_fits(args, (t, n, c, b, trips), want, retried, None, mutant)
    lines = found.faults + found.near_ties
    if finds is None:
        assert not lines and len(found.differ) == 1, found.summary()
        return
    assert len(lines) == 1 and f"lane {i}" in lines[0] and finds in lines[0], lines
    if change == "knots":
        # a near-tie only where the decision it names came within NEAR_TIE
        _, margin = part2_check.divergence(part2_check.lane(args, i), t[i], int(n[i]))
        assert (found.near_ties == lines) == (margin <= part2_check.NEAR_TIE)


def test_divergence_names_the_insertion_the_kernel_lacks():
    """Dropping any one knot of a lane's plain set: the first plain decision
    the kernel's knots contradict is the insertion of that knot, with a
    margin in (0, 1]."""
    args, want, _ = _plain("seeded (6, 512) s=0.2")
    one = part2_check.lane(args, 5)
    knots = want[0][5, : int(want[1][5])]
    assert part2_check.divergence(one, knots, len(knots)) is None
    for k in range(len(knots)):
        kernel = torch.cat([knots[:k], knots[k + 1 :]])
        where, margin = part2_check.divergence(one, kernel, len(kernel))
        assert where.startswith("insertion") and repr(float(knots[k])) in where, where
        assert 0.0 < margin <= 1.0


def test_divergence_finds_a_kernel_that_went_on(monkeypatch):
    """A kernel that inserted the knot the plain side would have inserted
    after its last solve parted ways at the done test that ended part 1."""
    args, want, _ = _plain("seeded (6, 512) s=0.2")
    one = part2_check.lane(args, 3)
    seen = []
    stats = tfp._interval_stats

    def recording(x, m, resid, t_int, n_int, endpoint_mask):
        fpint, nrdata = stats(x, m, resid, t_int, n_int, endpoint_mask)
        seen.append((x, m, t_int, n_int, fpint, nrdata, endpoint_mask))
        return fpint, nrdata

    monkeypatch.setattr(tfp, "_interval_stats", recording)
    _, n_plain, *_ = tfp.fitpack_parts12_plain(*one)
    monkeypatch.setattr(tfp, "_interval_stats", stats)
    t_next, n_next, _, _ = tfp._insert_knot(*seen[-1])
    assert int(n_next[0]) == int(n_plain[0]) + 1 == int(want[1][3]) + 1
    where, margin = part2_check.divergence(one, t_next[0], int(n_next[0]))
    # the knots cannot tell this from one more insertion in the last round
    # that inserted: both are named, and the lesser margin counts
    assert "the done test" in where and "went on" in where, where
    assert 0.0 < margin < 1.0


def test_hairpin_copies_break_down_and_retry():
    """The card check's inputs for the kernel's step after a breakdown:
    noisy copies of the acceleration hairpin's fit on which the plain part
    2 retries a trial that was not finite, and converges."""
    from ft_fsd_path_planning_torch import PathPlanner
    from ft_fsd_path_planning_torch.config import default_config
    from ft_fsd_path_planning_torch.parallel import scenarios
    from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes

    frames = scenarios.mission_sessions()["acceleration"][1][: part2_check.HAIRPIN_FRAME + 1]
    cfg = default_config(MissionTypes.acceleration, n_cones=128)
    planner = PathPlanner(MissionTypes.acceleration, config=cfg, device="cpu")
    fits = part2_check.capture_fits(lambda: [planner.calculate_path_in_global_frame(*f) for f in frames])
    hairpin = [a for a in fits if a[2].shape[1] == 704][-1]
    copies = part2_check.hairpin_copies(hairpin, 16)
    assert tuple(copies[2].shape) == (16, 704) and torch.equal(copies[2][0], hairpin[2][0])
    want, retried = part2_check.plain_parts12(copies)
    found = part2_check.judge_fits(copies, want, want, retried)
    assert not found.faults and found.retried > 0 and found.retried_same_trips == found.retried
    assert found.converged > 0


if __name__ == "__main__":
    np.savez_compressed(GOLDEN, **outputs())
    print(f"wrote {GOLDEN}")
