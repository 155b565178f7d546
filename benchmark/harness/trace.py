"""Read a `torch.profiler` trace of the traced window.

From the profiler's raw events (not `prof.events()`, which would first
build a tree of Python objects out of some hundred thousand of them):
device busy time as the union of the device's operation intervals inside
the window, kernels by name, the CUDA runtime's synchronising calls, the
heaviest device operations, and the longest idle gaps, each named by the
innermost host event that was running at its middle.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

WINDOW = "bench.window"
#: runtime calls that block the host until the device catches up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: int
    syncs: int
    kernel_s_by_name: dict = field(default_factory=dict)
    kernel_n_by_name: dict = field(default_factory=dict)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def kernel_seconds(self, fragment: str) -> float:
        return sum(s for n, s in self.kernel_s_by_name.items() if fragment in n)


def run_traced(fn):
    """(fn's result, Trace) of ``fn()`` run under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            result = fn()
            torch.cuda.synchronize()
    t0 = time.perf_counter()
    trace = read(prof.profiler.kineto_results.events())
    return result, trace, time.perf_counter() - t0


#: prefixes of the harness's own `record_function` ranges; the profiler
#: mirrors them on the device's timeline, where they are no device work
MARKERS = ("bench.", "stage.")
MEMORY_OPS = ("Memcpy", "Memset", "memcpy", "memset")
#: characters of a kernel's name kept in the breakdown
NAME_CHARS = 120


def read(events) -> Trace:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    w0 = w1 = None
    for e in events:
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if not name.startswith(MARKERS):
                dev.append((start, start + dur, name, not name.startswith(MEMORY_OPS)))
        else:
            if name == WINDOW:
                w0, w1 = start, start + dur
            host.append((start, start + dur, name))
    if w0 is None:
        raise RuntimeError("the trace holds no window marker")
    dev = [d for d in dev if d[1] > w0 and d[0] < w1]
    if not dev:
        raise RuntimeError("the trace holds no device operation: the profiler saw no CUDA activity")
    dev.sort()

    by_name_s: dict = defaultdict(float)
    by_name_n: dict = defaultdict(int)
    busy = 0
    cur_s, cur_e = None, None
    kernels = 0
    for s, e, name, is_kernel in dev:
        s, e = max(s, w0), min(e, w1)
        by_name_s[name] += (e - s) / 1e9
        by_name_n[name] += 1
        kernels += is_kernel
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s

    syncs = sum(1 for s, _, n in host if w0 <= s <= w1 and n in SYNC_CALLS)

    # idle gaps between device operations, named by the innermost host event
    ends = np.maximum.accumulate(np.array([d[1] for d in dev]))
    starts = np.array([d[0] for d in dev])
    gap_s = np.concatenate([[w0], ends])
    gap_e = np.concatenate([starts, [w1]])
    lengths = gap_e - gap_s
    top = np.argsort(-lengths)[:10]
    h_s = np.array([h[0] for h in host])
    h_e = np.array([h[1] for h in host])
    idle = []
    for g in top:
        if lengths[g] <= 0:
            break
        mid = (gap_s[g] + gap_e[g]) / 2
        inside = np.flatnonzero((h_s <= mid) & (h_e >= mid))
        inside = [i for i in inside if host[i][2] != WINDOW]
        label = min(inside, key=lambda i: h_e[i] - h_s[i]) if inside else None
        name = host[label][2][:NAME_CHARS] if label is not None else "python (no host op)"
        idle.append([name, float(lengths[g]) / 1e9])

    heaviest = sorted(by_name_s.items(), key=lambda kv: -kv[1])[:10]
    return Trace(
        window_s=(w1 - w0) / 1e9,
        busy_s=busy / 1e9,
        kernels=kernels,
        syncs=syncs,
        kernel_s_by_name=dict(by_name_s),
        kernel_n_by_name=dict(by_name_n),
        device_ops=[[n[:NAME_CHARS], s] for n, s in heaviest],
        idle_gaps=idle,
    )
