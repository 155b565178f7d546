"""Timing and device profiling utilities.

Counterpart of `ft_fsd_path_planning_tpu/utils/timer.py`, API-compatible
with the reference Timer (utils/utils.py:17-126). On the CPU a block is
timed with the host clock; on a CUDA device with a pair of CUDA events
around it, so the interval is the device's time for the work enqueued inside
the block and not the time it took to enqueue it. ``device_trace`` captures
a `torch.profiler` trace around a block.

``span`` and ``count`` time parts of a frame and count events inside the
program; ``spanned`` is ``span`` around the whole of a function. They record only inside ``recording()`` or while a `torch.profiler`
session is recording; otherwise each is one flag check and nothing more.
While recording, a span is also a `record_function` range under its name, so
the profiler's trace holds it on the same clock as the device's kernels.
Every span name starts with ``stage.``. ``table()`` reads what was recorded
since the last ``reset()``.
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import Dict, List

import torch
from torch.autograd import profiler as _autograd_profiler


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


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------

#: calls and host nanoseconds of each span since the last reset
_spans: Dict[str, List[int]] = {}
#: each counter's total since the last reset
_counts: Dict[str, int] = {}
#: depth of open ``recording()`` blocks
_recording = 0
_OFF = nullcontext()


class _Span:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> None:
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter_ns()

    def __exit__(self, *exc) -> None:
        ns = time.perf_counter_ns() - self._t0
        self._range.__exit__(*exc)
        entry = _spans.get(self.name)
        if entry is None:
            _spans[self.name] = [1, ns]
        else:
            entry[0] += 1
            entry[1] += ns


def span(name: str):
    """A context manager that adds the host time of its block to ``name``
    and names the block in the profiler's trace, while recording."""
    if _recording or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def spanned(name: str):
    """A decorator: the function's whole body is the span ``name``. A
    wrapper that a caller puts on the module attribute later still runs
    outside the span."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if _recording or _autograd_profiler._is_profiler_enabled:
                with _Span(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)

        return run

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, while recording."""
    if _recording or _autograd_profiler._is_profiler_enabled:
        _counts[name] = _counts.get(name, 0) + n


@contextmanager
def recording():
    """Record spans and counters inside the block, with or without a
    profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def table() -> dict:
    """``{span: {"n": calls, "ns": host nanoseconds}}`` and ``{counter:
    total}``, recorded since the last ``reset()``."""
    out: dict = {name: {"n": n, "ns": ns} for name, (n, ns) in _spans.items()}
    out.update(_counts)
    return out


def reset() -> None:
    """Clear every span and counter."""
    _spans.clear()
    _counts.clear()
