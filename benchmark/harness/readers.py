"""Arithmetic the per-layer metric readers share. A reader that finds
nothing to read returns None, and the metric is left out of the line."""

from __future__ import annotations


def stage_ms(ctx: dict, stage: str):
    """Wall ms of one stage a frame or step of the staged pass."""
    seconds = ctx["stage_s"].get(stage)
    if not seconds:
        return None
    return 1e3 * seconds / ctx["staged_units"]


def roofline(ctx: dict, kernel: str, name_fragment: str):
    """The kernel's bound (from the operations and bytes of every launch in
    the traced window) over its device time there, in %."""
    launches = ctx["launches"]
    device_s = ctx["trace"].kernel_seconds(name_fragment)
    if launches.count[kernel] == 0 or device_s <= 0:
        return None
    return 100.0 * launches.bound_s[kernel] / device_s
