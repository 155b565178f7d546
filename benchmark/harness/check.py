"""Decide `correct`: the served answers against the plain reference.

Each number compared has its limit in the configuration's ``check`` block;
the others are read only by `control.py`, which records every number. The
reference runs once the window has closed, the device's peak has been read
and the program's state has been freed.
"""

from __future__ import annotations

import math
import sys

import numpy as np

from reference.compare import curvature_gap, lateral_gap


def compare(loop, limits: dict, rng: np.random.Generator) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the loop's answers, for
    the numbers ``limits`` holds (`control.py` passes every number)."""
    path_gaps, curv_gaps = [], []
    unanswered = reference_fallbacks = 0
    for key, served in loop.to_check(rng):
        ref = loop.reference(key)
        if ref is None:
            reference_fallbacks += 1
            continue
        if served is None:
            unanswered += 1
            continue
        path_gaps.append(lateral_gap(served, ref))
        curv_gaps.append(curvature_gap(served, ref))
    none = [math.inf]
    numbers = {
        "path_gap_m": max(path_gaps or none),
        "path_gap_p50_m": float(np.median(path_gaps or none)),
        "curvature_gap_per_m": max(curv_gaps or none),
        "curvature_gap_p50_per_m": float(np.median(curv_gaps or none)),
        "unanswered": unanswered,
        "reference_fallbacks": reference_fallbacks,
    }
    report = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items() if k in limits}
    correct = all(v["value"] <= v["limit"] for v in report.values())
    return correct, report


def print_report(report: dict, note: str = "") -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error."""
    if note:
        print(note, file=sys.stderr)
    for name, v in report.items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
