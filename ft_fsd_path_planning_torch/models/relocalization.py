"""Relocalization state.

Counterpart of the state part of
`ft_fsd_path_planning_tpu/models/relocalization.py`: :class:`RelocState`
carries the SE(2) transform of the skidpad and acceleration relocalizers
(forward p' = R(rot) (p + t - c) + c). The planner state carries it on every
mission; the relocalizers themselves are not ported yet (ROADMAP.md, Queue
A10).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class RelocState(NamedTuple):
    has_origin: Tensor  # (B,) bool — original pose stored
    origin_position: Tensor  # (B, 2)
    origin_direction: Tensor  # (B, 2)
    relocalized: Tensor  # (B,) bool
    rotation: Tensor  # (B,)
    translation: Tensor  # (B, 2)
    center: Tensor  # (B, 2)

    @staticmethod
    def initial(batch: int, device: torch.device) -> "RelocState":
        def zeros(*shape, dtype=torch.float32):
            return torch.zeros((batch,) + shape, dtype=dtype, device=device)

        return RelocState(
            has_origin=zeros(dtype=torch.bool),
            origin_position=zeros(2),
            origin_direction=zeros(2),
            relocalized=zeros(dtype=torch.bool),
            rotation=zeros(),
            translation=zeros(2),
            center=zeros(2),
        )
