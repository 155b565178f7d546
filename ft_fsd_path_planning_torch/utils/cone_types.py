"""Cone type enum.

Same integer encoding as the reference `fsd_path_planning/utils/cone_types.py`
and the JAX package, so replay logs and user code interoperate; used as plain
integer codes inside tensors.
"""

from __future__ import annotations

from enum import IntEnum


class ConeTypes(IntEnum):
    """All possible cone types. Values are stable wire-format codes."""

    UNKNOWN = 0
    RIGHT = 1
    YELLOW = 1
    LEFT = 2
    BLUE = 2
    START_FINISH_AREA = 3
    ORANGE_SMALL = 3
    START_FINISH_LINE = 4
    ORANGE_BIG = 4


#: Color code used for padding slots in fixed-shape cone tensors. Chosen
#: negative so it never collides with a real ConeTypes value.
PAD_CONE_TYPE = -1


def invert_cone_type(cone_type: ConeTypes) -> ConeTypes:
    """LEFT <-> RIGHT, all other types map to themselves."""
    if cone_type == ConeTypes.LEFT:
        return ConeTypes.RIGHT
    if cone_type == ConeTypes.RIGHT:
        return ConeTypes.LEFT
    return cone_type
