"""Which source lines of the port launch the kernels and make the host
syncs of one batched planner step.

    python -m ft_fsd_path_planning_torch.profile_device [--batch 256] [--n-cones 128]
        [--mission trackdrive|skidpad|acceleration] [--top 25] [--device cuda|cpu]

Counterpart of `tools/profile_device.py` (per-op device time by stage and
source line from the XLA trace). Here every torch call the step makes runs
under a ``torch.profiler.record_function`` range named after the innermost
source line of this package on its Python stack and the pipeline stage (the
first of sorting, matching, pathing, relocalization, planner on that
stack), by a ``TorchFunctionMode``; the launches of the hand-written kernels
(B1, B2 and FITPACK's part 2) get a range of their own. After one step under ``torch.profiler``
each device kernel is credited to the range that launched it, so the count
and device time of every line and stage add up to the step's totals (a
kernel no range owns is counted as such; the hand-written kernels, launched
through ctypes, are credited to their wrappers' launches in launch order).
A second step runs under
``torch.cuda.set_sync_debug_mode("warn")``: each host-device
synchronisation is credited to the innermost line of the package that made
it and that line's caller, with its stack. On the CPU there are no kernels and no syncs: the unit
is the torch call, and syncs are reported absent (null), not 0.

Prints one JSON line (the totals, the stages, the heaviest lines by kernels,
the lines of ``ops/fitpack.py`` by kernels, alone and with their callers,
and by syncs, the kernels by fit site of ``models/pathing.py``) and writes every line to
``build/profile_device.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import torch
from torch.overrides import TorchFunctionMode

PACKAGE_DIR = str(Path(__file__).resolve().parent)
ROOT = Path(__file__).resolve().parents[1]
#: stage of a torch call: the first of these files on its Python stack
STAGE_FILES = (
    ("sorting", ("models/sorting.py", "models/sorting_cost.py", "ops/beam_search.py")),
    ("matching", ("models/matching.py",)),
    ("pathing", ("models/pathing.py",)),
    ("relocalization", ("models/relocalization.py",)),
    ("planner-other", ("models/planner.py",)),
)
_SELF = ("profile_device.py", "profile_pathing.py")
_RANGE = "port#"


def _port_frames(frame) -> list[tuple[str, int, str]]:
    """(file relative to the package, line, function) of each frame of this
    package on the stack from ``frame`` outwards, innermost first, the
    profiling tools themselves left out."""
    out = []
    while frame is not None:
        path = frame.f_code.co_filename
        if path.startswith(PACKAGE_DIR) and not path.endswith(_SELF):
            out.append((path[len(PACKAGE_DIR) + 1:], frame.f_lineno, frame.f_code.co_name))
        frame = frame.f_back
    return out


def stage_of(frames: list[tuple[str, int, str]]) -> str:
    for stage, files in STAGE_FILES:
        if any(f in files for f, _, _ in frames):
            return stage
    return "(outside the pipeline)"


def fit_site(frames: list[tuple[str, int, str]]) -> str | None:
    """The call site of ``models/pathing.py`` a FITPACK fit runs under: the
    pathing frame just outside the fit (`fitpack_fit`), or None."""
    for i, (f, _, fn) in enumerate(frames):
        if f == "ops/fitpack.py" and fn == "fitpack_fit":
            outer = [fr for fr in frames[i + 1:] if fr[0] == "models/pathing.py"]
            return " <- ".join(f"{f2}:{ln} {fn2}" for f2, ln, fn2 in outer[:2]) if outer else None
    return None


class Site:
    """Where a torch call or a kernel launch came from: its innermost line
    of the package, that line with its caller's (``call``: a helper such as
    FITPACK's loop condition `_any` is one line called from many), the
    stage, the fit site and the stack."""

    __slots__ = ("line", "call", "stage", "fit", "stack")

    def __init__(self, frames):
        self.stack = [f"{f}:{ln} {fn}" for f, ln, fn in frames] or ["(no frame of the package)"]
        self.line = self.stack[0]
        self.call = " <- ".join(self.stack[:2])
        self.stage = stage_of(frames)
        self.fit = fit_site(frames)


class _Tagger(TorchFunctionMode):
    """Runs every torch call under a profiler range that names its Site."""

    def __init__(self, sites: list):
        super().__init__()
        self.sites = sites
        self.index: dict[tuple, int] = {}

    def tag(self, frame) -> str:
        frames = _port_frames(frame)
        key = tuple(frames)
        i = self.index.get(key)
        if i is None:
            i = self.index[key] = len(self.sites)
            self.sites.append(Site(frames))
        return f"{_RANGE}{i}"

    def __torch_function__(self, func, types, args=(), kwargs=None):
        with torch.profiler.record_function(self.tag(sys._getframe(1))):
            return func(*args, **(kwargs or {}))


def _kernel_wrappers():
    """(module, name) of the wrappers that launch the hand-written kernels
    through ctypes, as the step looks them up."""
    from ft_fsd_path_planning_torch.ops import banded_cholesky, beam_search, fitpack, spline

    return [
        (spline, "banded_refined_solve_cuda"),
        (banded_cholesky, "banded_cholesky_solve_cuda"),
        (beam_search, "fused_beam_search_cuda"),
        (fitpack, "fitpack_parts12_cuda"),
    ]


@contextmanager
def tagged(sites: list, launches: list):
    """Inside the block every torch call and every launch of a hand-written kernel runs
    under a range naming its Site; ``launches`` receives the range of each
    kernel launch, in order."""
    tagger = _Tagger(sites)
    patched = []
    for module, name in _kernel_wrappers():
        original = getattr(module, name)

        def wrapper(*args, __original=original, **kwargs):
            tag = tagger.tag(sys._getframe(1))
            launches.append(tag)
            with torch.profiler.record_function(tag):
                return __original(*args, **kwargs)

        setattr(module, name, wrapper)
        patched.append((module, name, original))
    try:
        with tagger:
            yield
    finally:
        for module, name, original in patched:
            setattr(module, name, original)


def _owner(event):
    while event is not None and not event.name.startswith(_RANGE):
        event = event.cpu_parent
    return event


def attribute_kernels(run, device: torch.device) -> dict:
    """Run ``run()`` once under the profiler and the tagger; returns the
    sites and, per site index, [kernels, device ms] on a CUDA device or
    [torch calls, host ms] on the CPU, with the totals."""
    from torch.profiler import ProfilerActivity, profile

    sites: list = []
    launches: list = []
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    _sync(device)
    with profile(activities=activities) as prof:
        with tagged(sites, launches):
            t0 = time.perf_counter()
            run()
            _sync(device)
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    per_site: dict = defaultdict(lambda: [0, 0.0])
    if device.type != "cuda":
        for e in events:
            if e.name.startswith(_RANGE) and (e.cpu_parent is None or _owner(e.cpu_parent) is None):
                per_site[int(e.name[len(_RANGE):])][0] += 1
                per_site[int(e.name[len(_RANGE):])][1] += e.cpu_time_total / 1e3
        total = sum(v[0] for v in per_site.values())
        return {"unit": "torch calls", "sites": sites, "per_site": per_site, "total": total,
                "total_ms": sum(v[1] for v in per_site.values()), "unowned": 0, "wall_ms": wall_ms}
    # the device timeline also mirrors the ranges themselves, this tool's and
    # the program's own spans (user annotations): those are no device work
    device_events = [
        e for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith((_RANGE, "stage."))
    ]
    # the profiler hands a kernel to every CPU event of its correlation id;
    # of several, the innermost (latest to start) launched it
    launcher: dict = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.kernels:
            seen = launcher.get(e.id)
            if seen is None or e.time_range.start >= seen.time_range.start:
                launcher[e.id] = e
    owned = 0
    for e in launcher.values():
        kernels = [k for k in e.kernels if not _hand_written(k.name)]
        if not kernels:
            continue
        owner = _owner(e)
        key = int(owner.name[len(_RANGE):]) if owner is not None else -1
        per_site[key][0] += len(kernels)
        per_site[key][1] += sum(k.duration for k in kernels) / 1e3
        owned += len(kernels)
    # the hand-written kernels are launched through ctypes, outside any PyTorch op, so the
    # profiler may link their kernels to no range: they are credited to the
    # launches the wrappers recorded, in launch order (one stream)
    hand = sorted((e for e in device_events if _hand_written(e.name)), key=lambda e: e.time_range.start)
    if len(hand) == len(launches):
        for e, tag in zip(hand, launches):
            key = int(tag[len(_RANGE):])
            per_site[key][0] += 1
            per_site[key][1] += (e.time_range.end - e.time_range.start) / 1e3
        owned += len(hand)
    unowned = len(device_events) - owned
    if unowned:
        per_site[-1][0] += unowned
    return {"unit": "kernels", "sites": sites, "per_site": per_site, "total": len(device_events),
            "total_ms": sum((e.time_range.end - e.time_range.start) for e in device_events) / 1e3,
            "unowned": unowned, "wall_ms": wall_ms}


def _hand_written(kernel_name: str) -> bool:
    """Whether a device kernel is one of csrc/'s: B1, B2 or FITPACK's fit kernel."""
    return any(k in kernel_name for k in ("banded_cholesky_kernel", "beam_search_kernel", "fitpack_fit_kernel"))


def attribute_syncs(run, device: torch.device) -> dict | None:
    """Run ``run()`` once under the sync debug mode; returns per innermost
    line the syncs it made, with the stack of its first one and the stage,
    or None on the CPU, where nothing synchronises with a device."""
    if device.type != "cuda":
        return None
    per_line: dict = {}
    shown = warnings.showwarning

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return shown(message, category, filename, lineno, file, line)
        site = Site(_port_frames(sys._getframe(1)))
        entry = per_line.setdefault(site.call, {"syncs": 0, "stage": site.stage, "fit": site.fit, "stack": site.stack})
        entry["syncs"] += 1
        return None

    _sync(device)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
            _sync(device)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = shown
    return per_line


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def by_key(result: dict, key) -> dict:
    """Sum [count, ms] of the sites by ``key(site)`` (None: not counted)."""
    out: dict = defaultdict(lambda: [0, 0.0])
    for i, (count, ms) in result["per_site"].items():
        k = key(result["sites"][i]) if i >= 0 else "(no range owns it)"
        if k is not None:
            out[k][0] += count
            out[k][1] += ms
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def report(result: dict, syncs: dict | None, top: int) -> dict:
    lines = by_key(result, lambda s: s.line)
    total_lines = sum(v[0] for v in lines.values())
    assert total_lines == result["total"], (total_lines, result["total"])
    unit = result["unit"]
    fitpack_syncs = None
    if syncs is not None:
        fitpack_syncs = {k: v["syncs"] for k, v in sorted(syncs.items(), key=lambda kv: -kv[1]["syncs"])
                         if k.startswith("ops/fitpack.py")}
    return {
        "unit": unit,
        "total": result["total"],
        "total_ms": result["total_ms"],
        "wall_ms_under_profiler": result["wall_ms"],
        "unowned": result["unowned"],
        "lines": len(lines),
        "by_stage": {k: {unit: v[0], "ms": v[1]} for k, v in by_key(result, lambda s: s.stage).items()},
        "by_fit_site": {k: {unit: v[0], "ms": v[1]} for k, v in by_key(result, lambda s: s.fit).items()},
        "top_lines": [{"line": k, unit: v[0], "ms": v[1]} for k, v in list(lines.items())[:top]],
        "fitpack_lines": [{"line": k, unit: v[0], "ms": v[1]} for k, v in lines.items() if k.startswith("ops/fitpack.py")][:top],
        "fitpack_calls": [{"call": k, unit: v[0], "ms": v[1]} for k, v in by_key(result, lambda s: s.call).items()
                          if k.startswith("ops/fitpack.py")][:top],
        "syncs": None if syncs is None else sum(v["syncs"] for v in syncs.values()),
        "syncs_by_stage": None if syncs is None else _sum_by(syncs, "stage"),
        "fitpack_sync_lines": fitpack_syncs,
        "all_lines": {k: {unit: v[0], "ms": v[1]} for k, v in lines.items()},
        "sync_lines": syncs,
    }


def _sum_by(syncs: dict, field: str) -> dict:
    out: dict = defaultdict(int)
    for v in syncs.values():
        out[v[field]] += v["syncs"]
    return dict(out)


def step_inputs(mission: str, batch_size: int, n_cones: int, device: torch.device):
    """(cfg, state, frames) of one batched step of the profile_step cells."""
    from ft_fsd_path_planning_torch.config import default_config
    from ft_fsd_path_planning_torch.parallel import batch, scenarios
    from ft_fsd_path_planning_torch.utils.mission_types import MissionTypes

    cfg = default_config(getattr(MissionTypes, mission), n_cones=n_cones)
    state = batch.make_batch_state(cfg, batch_size, device)
    if cfg.has_relocalizer:
        frames = scenarios.mission_frame_batch(cfg, batch_size, seed=0, device=device)[0]
    else:
        frames = scenarios.make_frame_batch(cfg, batch_size, seed=0, device=device)
    return cfg, state, frames


def device_name(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def profile_step(mission: str, batch_size: int, n_cones: int, device: torch.device, top: int) -> dict:
    from ft_fsd_path_planning_torch.parallel import batch

    cfg, state, frames = step_inputs(mission, batch_size, n_cones, device)
    run = lambda: batch.batched_step(cfg, state, frames)  # noqa: E731
    run()  # warm-up: the kernels' build and load, the allocator
    result = attribute_kernels(run, device)
    syncs = attribute_syncs(run, device)
    return {"device": device_name(device), "mission": mission, "batch": batch_size, "n_cones": n_cones,
            **report(result, syncs, top)}


def main(argv: list[str] | None = None) -> dict:
    from ft_fsd_path_planning_torch.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--n-cones", type=int, default=128)
    parser.add_argument("--mission", choices=("trackdrive", "skidpad", "acceleration"), default="trackdrive")
    parser.add_argument("--top", type=int, default=25)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--out", default=str(ROOT / "build" / "profile_device.json"))
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    out = profile_step(args.mission, args.batch, args.n_cones, device, args.top)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k not in ("all_lines", "sync_lines")}), flush=True)
    return out


if __name__ == "__main__":
    main()
