"""The trace reader on a made-up trace: busy time is the union of device
operations inside the window, markers mirrored on the device are no work,
syncs are counted, gaps are named by the innermost host event."""

import pytest
import torch

from harness import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Event:
    def __init__(self, name, device, start, end):
        self._n, self._d, self._s, self._e = name, device, start, end

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s


def test_read_a_made_up_trace():
    events = [
        Event(trace.WINDOW, CPU, 0, 1000),
        Event(trace.WINDOW, CUDA, 0, 1000),  # the marker's mirror on the device
        Event("stage.pathing", CPU, 100, 900),
        Event("aten::item", CPU, 500, 700),
        Event("cudaStreamSynchronize", CPU, 550, 690),
        Event("kernel_a", CUDA, 100, 300),
        Event("kernel_b", CUDA, 250, 400),  # overlaps kernel_a
        Event("Memcpy DtoH (Device -> Pageable)", CUDA, 690, 700),
        Event("kernel_a", CUDA, 800, 850),
    ]
    t = trace.read(events)
    assert t.window_s == pytest.approx(1000e-9)
    assert t.busy_s == pytest.approx((300 + 10 + 50) * 1e-9)
    assert t.kernels == 3 and t.syncs == 1
    assert t.kernel_seconds("kernel_a") == pytest.approx(250e-9)
    gaps = dict((n, s) for n, s in t.idle_gaps)
    assert gaps["aten::item"] == pytest.approx(290e-9)  # 400 -> 690, inside the item call
    assert gaps["stage.pathing"] == pytest.approx(100e-9)  # 700 -> 800
    assert t.device_ops[0][0] == "kernel_a"


def test_a_trace_without_device_work_is_refused():
    with pytest.raises(RuntimeError):
        trace.read([Event(trace.WINDOW, CPU, 0, 10), Event("aten::add", CPU, 1, 2)])
