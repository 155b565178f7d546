"""ft-fsd-path-planning-torch — the Formula Student path planner in PyTorch.

A port of `ft_fsd_path_planning_tpu` (JAX) to PyTorch and CUDA: cone sorting
(beam search), cone matching and centerline calculation, natively batched
over a leading frame axis, with the banded Cholesky solve of the spline
engine as a hand-written CUDA kernel (`csrc/banded_cholesky.cu`).

Numerics follow the JAX package: float32 throughout, TF32 off.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from ft_fsd_path_planning_torch.models.facade import PathPlanner  # noqa: E402
from ft_fsd_path_planning_torch.utils.cone_types import ConeTypes  # noqa: E402
from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes  # noqa: E402

__all__ = ["PathPlanner", "ConeTypes", "MissionTypes"]
