"""One run of one cell: set-up, the window (or the traced window and the
staged pass), the check, and the result object."""

from __future__ import annotations

import gc
import sys
import time

import numpy as np

from harness import cell as cells
from harness import check, host, probes, trace, yardstick


def _metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def run_cell(cell: cells.Cell, args, t0: float, device_name: str = "cuda") -> dict:
    """The result object of one run; ``device_name="cpu"`` is a dry run of
    the harness for the tests, never a measurement."""
    import torch

    on_card = device_name == "cuda"
    loop = cells.loop_module(cell).Loop(cell, args.seed, cells.track_module(cell), device_name)
    loop.setup()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    card = yardstick.card_info(0) if on_card else {"kind": "cpu", "power_limit_w": None}
    device = {"platform": "gpu", "kind": card["kind"], "count": cell.chips}
    metrics: dict = {}
    breakdown = None

    if args.trace:
        from ft_fsd_path_planning_torch.ops import fitpack

        # a fixed number of frames or steps on from set-up, so that a traced
        # run traces the same frames whatever the program's speed
        loop.to_traced()
        launches = probes.Launches()
        syncs0 = fitpack.loop_syncs
        with launches.active(), probes.stage_markers():
            units, tr, read_s = trace.run_traced(loop.traced_units)
        loop_syncs = fitpack.loop_syncs - syncs0
        table = probes.new_stage_table()
        with probes.stage_times(table):
            staged = loop.staged_units()
        ctx = {
            "trace": tr, "units": units, "loop_syncs": loop_syncs, "launches": launches,
            "stage_s": dict(table), "staged_units": staged,
        }
        for m in cell.per_layer:
            value = cells.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = _metric(value, m["unit"])
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
        print(f"trace: {units} {loop.unit}s in {tr.window_s!r} s, busy {tr.busy_s!r} s, "
              f"{tr.kernels} kernels, {tr.syncs} syncs, read in {read_s:.1f} s; "
              f"launches {launches.count}", file=sys.stderr)
    else:
        before = host.snapshot(device_name)
        elapsed = loop.window(args.seconds)
        after = host.snapshot(device_name)
        print(f"window: {loop.attempted} answers in {elapsed!r} s", file=sys.stderr)
        print(host.describe(before, after), file=sys.stderr)
        latencies = getattr(loop, "latencies", None)
        if latencies:
            tenths = np.array_split(1e3 * np.asarray(latencies), 10)
            print("window by tenths, median ms: " + " ".join(f"{np.median(t):.1f}" for t in tenths if len(t)),
                  file=sys.stderr)
        e2e = loop.end_to_end(elapsed)
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = _metric(e2e[m["name"]], m["unit"])

    device["memory_peak_bytes"] = 0
    if on_card:
        torch.cuda.synchronize()
        device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    device["power_limit_w"] = card["power_limit_w"]
    loop.finish()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    correct, report = check.compare(
        loop, cell.config["check"], np.random.default_rng([args.seed, 1])
    )
    check.print_report(report, f"checked in {time.perf_counter() - t_check:.1f} s")
    result = {
        "correct": correct,
        "attempted": loop.attempted,
        "failed": loop.failed,
        "metrics": metrics,
        "device": device,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = report
    return result
