"""What the host and the card did around a window, printed on standard error
beside each run, so that a spread of host-clock times between runs can be
read against it: the host's speed at a fixed piece of Python and at
launching small kernels, the process's share of the wall clock and its
involuntary context switches, and the card's clocks, power and throttle
reasons."""

from __future__ import annotations

import resource
import subprocess
import time

#: the card's readings, by nvidia-smi's names
GPU_FIELDS = "clocks.sm,clocks.mem,power.draw,temperature.gpu,clocks_throttle_reasons.active"


def _python_ms() -> float:
    """Best of three timings of a fixed piece of pure Python, in ms."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        sum(i * i for i in range(200_000))
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def _launch_us(device: str) -> float | None:
    """Host microseconds a small kernel launch takes, over 2,000 launches
    and one synchronise."""
    if device != "cuda":
        return None
    import torch

    x = torch.zeros(16, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        x.add_(1.0)
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / 2000


def _gpu(device: str) -> str | None:
    if device != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={GPU_FIELDS}", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20,
        )
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def snapshot(device: str) -> dict:
    return {
        "python_ms": _python_ms(), "launch_us": _launch_us(device), "gpu": _gpu(device),
        "wall": time.perf_counter(), "cpu": time.process_time(),
        "rusage": resource.getrusage(resource.RUSAGE_SELF),
    }


def describe(before: dict, after: dict) -> str:
    """One line: ``before -> after`` readings and the shares over the window."""
    wall = after["wall"] - before["wall"]
    cpu = after["cpu"] - before["cpu"]
    switches = after["rusage"].ru_nivcsw - before["rusage"].ru_nivcsw

    def pair(key: str, fmt: str) -> str:
        a, b = before[key], after[key]
        return "n/a" if a is None or b is None else f"{a:{fmt}} -> {b:{fmt}}"

    return (
        f"host: python {pair('python_ms', '.2f')} ms, launch {pair('launch_us', '.2f')} us; "
        f"process cpu/wall {cpu / wall:.3f}, involuntary switches {switches}; "
        f"card [{before['gpu']}] -> [{after['gpu']}]"
    )
