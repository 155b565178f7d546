"""Timing and device profiling utilities.

Counterpart of `ft_fsd_path_planning_tpu/utils/timer.py`, API-compatible
with the reference Timer (utils/utils.py:17-126). On the CPU a block is
timed with the host clock; on a CUDA device with a pair of CUDA events
around it, so the interval is the device's time for the work enqueued inside
the block and not the time it took to enqueue it. ``device_trace`` captures
a `torch.profiler` trace around a block.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List

import torch


class Timer:
    """Context-manager timer with interval accumulation.

    ``device`` chooses the clock: ``None`` or a CPU device the host's
    ``time.perf_counter``; a CUDA device CUDA events on its current stream
    (leaving the block synchronises on the second event)."""

    _intervals: Dict[str, List[float]] = defaultdict(list)

    def __init__(
        self, name: str = "timer", noprint: bool = False, device: str | torch.device | None = None
    ) -> None:
        self.name = name
        self.noprint = noprint
        self.device = torch.device("cpu" if device is None else device)
        self._start = 0.0
        self._events: tuple[torch.cuda.Event, torch.cuda.Event] | None = None
        self.interval = 0.0

    def __enter__(self) -> "Timer":
        if self.device.type == "cuda":
            self._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self._events[0].record(torch.cuda.current_stream(self.device))
        else:
            self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self._events is not None:
            start, end = self._events
            end.record(torch.cuda.current_stream(self.device))
            end.synchronize()
            self.interval = start.elapsed_time(end) / 1e3
            self._events = None
        else:
            self.interval = time.perf_counter() - self._start
        Timer._intervals[self.name].append(self.interval)
        if not self.noprint:
            print(self.report())

    @property
    def intervals(self) -> List[float]:
        return Timer._intervals[self.name]

    @property
    def cum_time(self) -> float:
        return sum(self.intervals)

    @property
    def mean_time(self) -> float:
        iv = self.intervals
        return sum(iv) / len(iv) if iv else 0.0

    def report(self) -> str:
        iv = self.intervals
        return (
            f"{self.name}: last {self.interval * 1000:.2f} ms | "
            f"n={len(iv)} mean {self.mean_time * 1000:.2f} ms "
            f"cum {self.cum_time * 1000:.1f} ms"
        )

    @classmethod
    def reset(cls) -> None:
        cls._intervals = defaultdict(list)


@contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace (host and, where there is a CUDA
    device, device activity) around a block; the Chrome trace is written to
    ``log_dir/trace.json``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
