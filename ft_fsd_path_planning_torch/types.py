"""Array type aliases (parity with reference `fsd_path_planning/types.py`).

Counterpart of `ft_fsd_path_planning_tpu/types.py`: device arrays are
``torch.Tensor`` here.
"""

from __future__ import annotations

from typing import Any

import torch

FloatArray = torch.Tensor
IntArray = torch.Tensor
BoolArray = torch.Tensor
GenericArray = torch.Tensor
NumpyArray = Any  # host-side numpy arrays at the facade boundary
