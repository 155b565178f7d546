"""The parameterization kernel (csrc/path_parameterize.cu) against its plain
version: the inputs of every parameterization of a drive, captured, and
edge lanes made on purpose; both sides run on the same device.
`chip_smoke.py` and `tests/test_torch_param_kernel_card.py` compare on the
card; the judgement (:func:`judge`) and the inputs run on the CPU too, where
the tests hold them.

The bar: on every lane the count of samples, the horizon's indices, ok and
every row (u, x, y and the filtered curvature) equal, as floats, NaN where
NaN. The kernel evaluates with the plain version's operations in its order,
and adds a window's moments and the filter's box in the order PyTorch's
CUDA reduction adds them (csrc/path_parameterize.cu). No limit would do in
place of equality: the float32 hyper-fit is chaotic on a nearly straight
window, where cov_xy = mxx myy - mxy^2 cancels. Added in slot order, the
moments of a window on the skidpad exit gave a radius of 14.6 m where the
plain version read 281 m (float64: 206 m; a NumPy copy of that order on a
CPU), and on the card a kernel adding in that order read a horizon row's
filtered curvature 6.3e-4 1/m where the plain version read 3.3e-4 (call
513 of a skidpad run); on the curved windows of a trackdrive lap the two
orders part by up to 8.4e-3 of the curvature (the median 8e-5). A limit
loose enough for the one passes a wrong window or filter on the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ft_fsd_path_planning_torch import PathPlanner
from ft_fsd_path_planning_torch.config import default_config
from ft_fsd_path_planning_torch.models import pathing
from ft_fsd_path_planning_torch.ops import fitpack as fpk
from ft_fsd_path_planning_torch.parallel import batch, dryrun, scenarios
from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes
from tests import matching_check

FIELDS = ("ok", "n_pts", "indices", "out")
COLUMNS = ("u", "x", "y", "curvature")


@dataclasses.dataclass
class Comparison:
    """What the comparisons of one case found, over all their lanes."""

    calls: int = 0
    lanes: int = 0
    short_lanes: int = 0  # lanes with fewer samples than the horizon (ok False)
    faults: list = dataclasses.field(default_factory=list)

    def summary(self, label: str) -> str:
        return (
            f"param kernel vs plain on {label}: {self.calls} calls, {self.lanes} lanes "
            f"({self.short_lanes} short), faults {len(self.faults)} (u, x, y, curvature, n_pts, the "
            f"horizon's indices and ok equal bit for bit on every other lane)"
        )


def _same(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise: equal, or NaN on both sides."""
    return (a == b) | (torch.isnan(a) & torch.isnan(b))


def judge(got: pathing.ParamTail, want: pathing.ParamTail, found: Comparison, label: str) -> None:
    """Add one call's verdict to ``found``: every field and every column of
    the rows equal on every lane."""
    found.calls += 1
    found.lanes += want.ok.shape[0]
    found.short_lanes += int((~want.ok).sum())
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if a.dtype != b.dtype or a.shape != b.shape:
            found.faults.append(f"{label}: {name} {a.dtype} {tuple(a.shape)} != {b.dtype} {tuple(b.shape)}")
            return
    for name in FIELDS[:-1]:
        lanes = torch.nonzero((getattr(got, name) != getattr(want, name)).reshape(want.ok.shape[0], -1).any(dim=1))
        if lanes.numel():
            found.faults.append(f"{label}: {name} differs on lanes {lanes.flatten()[:8].tolist()}")
    for col, name in enumerate(COLUMNS):
        lanes = torch.nonzero(~_same(got.out[..., col], want.out[..., col]).all(dim=1))
        if lanes.numel():
            found.faults.append(f"{label}: {name} differs on lanes {lanes.flatten()[:8].tolist()}")


def compare(cfg, fit: fpk.FpSpline, predict_every: torch.Tensor, p_eval: int, found: Comparison,
            label: str) -> None:
    """Run the kernel and the plain version on one call's inputs (on the
    card) and judge: the kernel must have launched once."""
    want = pathing.parameterize_tail_plain(cfg, fit, predict_every, p_eval)
    launches = pathing.launch_count
    got = pathing.parameterize_tail_cuda(cfg, fit, predict_every, p_eval)
    torch.cuda.synchronize()
    if pathing.launch_count != launches + 1:
        found.faults.append(f"{label}: the kernel launched {pathing.launch_count - launches} times")
    judge(got, want, found, label)


def capture(run) -> list[tuple]:
    """Call ``run()`` and keep (cfg, fit, predict_every, p_eval) of every
    parameterization tail it runs."""
    calls = []
    original = pathing.parameterize_tail

    def recording(cfg, fit, predict_every, p_eval):
        calls.append((cfg, fpk.FpSpline(*(t.clone() for t in fit)), predict_every.clone(), p_eval))
        return original(cfg, fit, predict_every, p_eval)

    pathing.parameterize_tail = recording
    try:
        run()
    finally:
        pathing.parameterize_tail = original
    return calls


def _trace(kind: str, m: int) -> np.ndarray:
    """A trace of ``m`` points 0.1 m apart of one ``kind``."""
    s = 0.1 * np.arange(m)
    if kind.startswith("arc"):
        r = float(kind[3:])
        return np.stack([r * np.sin(s / r), r - r * np.cos(s / r)], axis=1)
    if kind == "s-curve":
        return np.stack([s, 2.0 * np.sin(s / 3.0)], axis=1)
    if kind == "straight":
        return np.stack([s * 0.6, -s * 0.8 + 40.0], axis=1)
    if kind == "one point":
        return np.tile([[3.0, -2.0]], (m, 1))
    raise ValueError(kind)


#: edge lanes: (kind of trace, points, samples wanted); the counts cover no
#: sample, fewer than a window of 5, fewer than the horizon, the horizon, the
#: counts at which the card's product by 1 / (H - 1) truncates the last index
#: otherwise than a division would (108, 112, 176, 184), every slot
EDGE_LANES = (
    ("arc5", 120, 60), ("arc15", 120, 121), ("arc50", 150, 108), ("arc400", 150, 112),
    ("arc3000", 150, 192), ("straight", 150, 176), ("s-curve", 150, 184), ("s-curve", 150, 40),
    ("arc15", 40, 39), ("arc50", 30, 9), ("arc5", 20, 4), ("arc15", 4, 2), ("arc5", 3, 1),
    ("straight", 100, 0), ("one point", 50, 10),  # a chord length of 0 keeps no sample
)


def edge_input(device, p_eval: int = 192) -> tuple[list[str], fpk.FpSpline, torch.Tensor]:
    """The edge lanes as one batch: each trace padded to 256 sites, fitted
    on ``device`` with the refit's smoothing, and predict_every set so that
    the lane keeps the number of samples it wants (NaN for none)."""
    cfg = default_config()
    pts = np.zeros((len(EDGE_LANES), 256, 2), np.float32)
    mask = np.zeros((len(EDGE_LANES), 256), bool)
    for i, (kind, m, _) in enumerate(EDGE_LANES):
        pts[i, :m] = _trace(kind, m) + np.array([12.0, -7.0])
        mask[i, :m] = True
    fit = fpk.fitpack_fit(torch.tensor(pts, device=device), torch.tensor(mask, device=device), cfg.path.refit_smoothing)
    want = torch.tensor([n for _, _, n in EDGE_LANES], dtype=torch.float32, device=device)
    every = torch.where(want > 0, fit.u_max / (torch.clamp(want, max=p_eval) - 0.5), torch.full_like(want, float("nan")))
    names = [f"{kind}, {m} points, {n} samples" for kind, m, n in EDGE_LANES]
    return names, fit, every


def edge_configs() -> dict:
    """The planner's tail (W = 31) and the dry run's (W = 15)."""
    return {"W=31": default_config(), "W=15 (dry run's budget)": dryrun.tiny_config()}


def drives(device) -> dict:
    """The drives whose parameterizations the card's check captures, each a
    function that runs it: a lap of trackdrive.laps' traffic at B = 1, a
    whole skidpad run at B = 1, a trackdrive batched step at B = 256 and the
    initial path of both missions."""
    def lap():
        planner = PathPlanner(MissionTypes.trackdrive, config=default_config(n_cones=256), device=device)
        for frame in matching_check.lap_frames():
            planner.calculate_path_in_global_frame(*frame)

    def skidpad():
        planner = PathPlanner(MissionTypes.skidpad, device=device)
        for frame in scenarios.skidpad_session():
            planner.calculate_path_in_global_frame(*frame)

    def step():
        cfg = default_config(n_cones=128)
        frames = scenarios.make_frame_batch(cfg, 256, seed=1, device=device)
        batch.batched_step(cfg, batch.make_batch_state(cfg, 256, device), frames)

    def initial():
        for mission in (MissionTypes.trackdrive, MissionTypes.skidpad):
            pathing.initial_path_state(default_config(mission), 1, torch.device(device))

    return {
        "a trackdrive.laps lap (150 frames, B=1)": lap,
        "a skidpad run (568 frames, B=1)": skidpad,
        "a trackdrive batched_step B=256": step,
        "the initial path (trackdrive, skidpad)": initial,
    }
