"""Mission enum. Parity with reference `fsd_path_planning/utils/mission_types.py:11-25`."""

from __future__ import annotations

from enum import IntEnum


class MissionTypes(IntEnum):
    none = 0
    acceleration = 1
    skidpad = 2
    autocross = 3
    trackdrive = 4
    ebs_test = 5
    inspection = 6
    manual_driving = 7
