"""The program's configuration, as a benchmark configuration file states it."""

from __future__ import annotations


def planner_config(config: dict):
    from ft_fsd_path_planning_torch.config import default_config
    from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes

    p = config["planner"]
    return default_config(
        MissionTypes[p["mission"]],
        p["experimental_performance_improvements"],
        n_cones=p["n_cones"],
    )
