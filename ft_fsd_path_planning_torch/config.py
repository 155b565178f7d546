"""Static planner configuration.

Same fields and defaults as `ft_fsd_path_planning_tpu/config.py`, which
mirror the reference factories (`fsd_path_planning/config.py:28-163`).
:class:`ShapeBudget` fixes every padded tensor dimension of the pipeline;
the ragged arrays of the reference become padded, masked axes.
"""

from __future__ import annotations

import dataclasses
import math

from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes


@dataclasses.dataclass(frozen=True)
class SortingConfig:
    """Trace-sorter parameters (reference `config.py:28-41`)."""

    max_n_neighbors: int = 5
    max_dist: float = 6.5
    max_dist_to_first: float = 6.0
    max_length: int = 12
    threshold_directional_angle: float = math.radians(40.0)
    threshold_absolute_angle: float = math.radians(65.0)
    use_unknown_cones: bool = True
    # beam width of the fixed-shape search that replaces the reference's
    # exhaustive DFS (BEAM_FIDELITY.md: K=32 held every viable candidate)
    beam_width: int = 32
    # pruning constants hard-coded inside the reference DFS
    car_size: float = 2.1
    ellipse_major: float = 6.0
    ellipse_minor: float = 3.0
    between_dist: float = 6.0
    between_angle: float = math.radians(150.0)
    close_cone_dist: float = 4.0
    # cost function constants (cost_function.py)
    angle_cost_threshold: float = math.radians(40.0)
    distance_cost_threshold: float = 3.0
    side_search_distance: float = 6.0
    side_search_angle: float = math.pi / 1.5


@dataclasses.dataclass(frozen=True)
class MatchingConfig:
    """Cone-matching parameters (reference `config.py:114-129`)."""

    min_track_width: float = 3.0
    max_search_range: float = 5.0
    max_search_angle: float = math.radians(50.0)
    matches_should_be_monotonic: bool = False

    @property
    def major_radius(self) -> float:
        return self.max_search_range * 1.5

    @property
    def minor_radius(self) -> float:
        return self.min_track_width


@dataclasses.dataclass(frozen=True)
class PathConfig:
    """Path-calculation parameters (reference `config.py:44-59`)."""

    smoothing: float = 0.2
    predict_every: float = 0.1
    max_deg: int = 3
    maximal_distance_for_valid_path: float = 5.0
    mpc_path_length: float = 20.0
    mpc_prediction_horizon: int = 40
    refit_smoothing: float = 0.01
    curvature_radius_min: float = 1.0
    curvature_radius_max: float = 3000.0


@dataclasses.dataclass(frozen=True)
class ShapeBudget:
    """Fixed tensor dimensions of the whole pipeline (padded, masked axes)."""

    # max total cones per frame, all types flattened (pad color = -1)
    n_cones: int = 128
    # max cones in one sorted side config == SortingConfig.max_length
    config_len: int = 12
    # max cones per side after virtual-cone insertion (12 real + 12 virtual)
    side_len: int = 32
    # dense spline sample count of the path post-chain (0.1 m grid, > 50 m)
    dense_samples: int = 512
    # window size cap for the curvature circle fit
    curvature_window: int = 31
    # points kept from a global path around the vehicle (global-path branch)
    global_window: int = 384
    # skidpad relocalization budgets
    reloc_closest_cones: int = 20
    reloc_max_centers: int = 64

    def __post_init__(self) -> None:
        # the same range the JAX package accepts (there integer indices ride
        # float32 one-hot contractions, exact only below 2**24), so a config
        # is valid in both packages or in neither
        for name in ("n_cones", "config_len", "side_len", "dense_samples",
                     "global_window"):
            value = getattr(self, name)
            if not 0 < value < 2**24:
                raise ValueError(f"ShapeBudget.{name}={value} outside (0, 2**24)")


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Top-level static config: mission + stage configs + shape budget."""

    mission: MissionTypes = MissionTypes.trackdrive
    sorting: SortingConfig = SortingConfig()
    matching: MatchingConfig = MatchingConfig()
    path: PathConfig = PathConfig()
    shapes: ShapeBudget = ShapeBudget()
    experimental_performance_improvements: bool = False
    # when False the pathing stage runs without the global-path branch and
    # fits its centerline on a 64-slot buffer
    supports_global_path: bool = False

    @property
    def has_relocalizer(self) -> bool:
        return self.mission in (
            MissionTypes.acceleration,
            MissionTypes.ebs_test,
            MissionTypes.skidpad,
        )


def default_config(
    mission: MissionTypes = MissionTypes.trackdrive,
    experimental_performance_improvements: bool = False,
    n_cones: int | None = None,
    **overrides,
) -> PlannerConfig:
    """Mission preset mirroring the reference factory defaults.

    ``n_cones`` overrides the flattened-cone budget; pass 256+ for full
    SLAM-map workloads.
    """
    if mission in (
        MissionTypes.acceleration,
        MissionTypes.ebs_test,
        MissionTypes.skidpad,
    ):
        overrides.setdefault("supports_global_path", True)
    if "shapes" not in overrides and mission in (
        MissionTypes.acceleration,
        MissionTypes.ebs_test,
    ):
        # the acceleration known path needs a wider global window and dense
        # budget; built BEFORE folding n_cones in so the mission sizing
        # survives a user-supplied cone budget
        overrides["shapes"] = ShapeBudget(global_window=704, dense_samples=1024)
    if n_cones is not None:
        base = overrides.get("shapes", ShapeBudget())
        overrides["shapes"] = dataclasses.replace(base, n_cones=n_cones)
    return PlannerConfig(
        mission=mission,
        experimental_performance_improvements=experimental_performance_improvements,
        **overrides,
    )


def large_map_config(
    mission: MissionTypes = MissionTypes.trackdrive,
    experimental_performance_improvements: bool = False,
) -> PlannerConfig:
    """Preset sized for whole-SLAM-map frames (hundreds of cones)."""
    return default_config(mission, experimental_performance_improvements, n_cones=256)
