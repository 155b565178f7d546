"""Probes the traced run puts around the program's functions, from outside.

`launches` records the shape of every launch of kernels B1 and B2, for
their roofline; `stage_times` times the planner's stages with a synchronise
on either side, as the program's `profile_step.py::stage_times` does. Both
patch module attributes for the length of a ``with`` block and put the
originals back. Neither is in place during a measured window.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

from harness import yardstick as ys


@contextlib.contextmanager
def _patched(patches):
    originals = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, wrap in patches:
        setattr(mod, attr, wrap(getattr(mod, attr)))
    try:
        yield
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)


class Launches:
    """Bound seconds of every B1 and B2 launch made inside the block."""

    def __init__(self):
        self.bound_s = {"B1": 0.0, "B2": 0.0}
        self.count = {"B1": 0, "B2": 0}

    def _record(self, kernel, seconds):
        self.bound_s[kernel] += seconds
        self.count[kernel] += 1

    @contextlib.contextmanager
    def active(self):
        from ft_fsd_path_planning_torch.ops import banded_cholesky as bc
        from ft_fsd_path_planning_torch.ops import beam_search as bs
        from ft_fsd_path_planning_torch.ops import spline

        def refined(fn):
            def run(a, rhs):
                b, c, r = rhs.reshape(-1, rhs.shape[-2], rhs.shape[-1]).shape
                flops = b * ys.b1_refined_solve_flops(c, r)
                self._record("B1", ys.bound_seconds(flops, ys.b1_solve_bytes(b, c, r)))
                return fn(a, rhs)
            return run

        def bare(fn):
            def run(band, rhs):
                b, c, r = rhs.shape
                flops = b * ys.b1_solve_flops(c, r)
                self._record("B1", ys.bound_seconds(flops, ys.b1_solve_bytes(b, c, r)))
                return fn(band, rhs)
            return run

        def search(fn):
            def run(node_table, feats0, alive0, params, *, k, l, c, **kw):
                g, n = node_table.shape[0], node_table.shape[1]
                flops = g * ys.b2_search_flops(k, l, c)
                self._record("B2", ys.bound_seconds(flops, ys.b2_search_bytes(g, n, k, l, c)))
                return fn(node_table, feats0, alive0, params, k=k, l=l, c=c, **kw)
            return run

        with _patched([
            (spline, "banded_refined_solve_cuda", refined),
            (bc, "banded_cholesky_solve_cuda", bare),
            (bs, "fused_beam_search_cuda", search),
        ]):
            yield self


STAGES = (
    ("relocalization", "attempt_relocalization", "reloc"),
    ("sorting", "run_cone_sorting", "sorting"),
    ("matching", "run_cone_matching", "matching"),
    ("pathing", "run_path_calculation", "pathing"),
)


@contextlib.contextmanager
def stage_times(table: dict):
    """Add each stage's wall seconds to ``table[stage]`` inside the block."""
    import torch
    from ft_fsd_path_planning_torch.models import planner

    def timed(name):
        def wrap(fn):
            def run(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                table[name] += time.perf_counter() - t0
                return out
            return run
        return wrap

    patches = [(getattr(planner, mod), attr, timed(name)) for mod, attr, name in STAGES]
    with _patched(patches):
        yield table


@contextlib.contextmanager
def stage_markers():
    """Name each stage in the trace (a `record_function` range, no
    synchronise), so that an idle gap inside it is named after it."""
    from torch.profiler import record_function
    from ft_fsd_path_planning_torch.models import planner

    def marked(name):
        def wrap(fn):
            def run(*args, **kwargs):
                with record_function(f"stage.{name}"):
                    return fn(*args, **kwargs)
            return run
        return wrap

    with _patched([(getattr(planner, mod), attr, marked(name)) for mod, attr, name in STAGES]):
        yield


def new_stage_table() -> dict:
    return defaultdict(float)
