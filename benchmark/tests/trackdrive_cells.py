"""The two trackdrive cells, written out for the CPU tests. The harness runs
them, but the program is at fault on some of their frames (PERF.md, Open
questions), so BENCHMARK.json does not hold them yet: the change that
mends the program adds these entries to it."""

ONLINE, SWEEP = "trackdrive.online", "trackdrive.sweep"
NAMES = (ONLINE, SWEEP)

#: per-layer metrics of each cell: (name, unit, better)
_PER_LAYER = {
    ONLINE: [("device_idle_pct.online", "%", "lower"), ("kernels_per_frame.online", "kernels", "lower"),
             ("syncs_per_frame.online", "syncs", "lower"), ("fitpack_loop_syncs.online", "syncs", "lower"),
             ("pathing_ms.online", "ms", "lower"), ("sorting_ms.online", "ms", "lower"),
             ("matching_ms.online", "ms", "lower"), ("b2_roofline.online", "%", "higher"),
             ("b1_roofline.online", "%", "higher")],
    SWEEP: [("device_idle_pct.sweep", "%", "lower"), ("kernels_per_step.sweep", "kernels", "lower"),
            ("syncs_per_step.sweep", "syncs", "lower"), ("fitpack_loop_syncs.sweep", "syncs", "lower"),
            ("pathing_ms.sweep", "ms", "lower"), ("sorting_ms.sweep", "ms", "lower"),
            ("matching_ms.sweep", "ms", "lower"), ("b2_roofline.sweep", "%", "higher"),
            ("b1_roofline.sweep", "%", "higher")],
}
_MOVES = {ONLINE: "plan_ms_p50", SWEEP: "solves_per_s"}


def spec() -> dict:
    """The cells in the form of BENCHMARK.json, for `harness.cell.load_cell`."""
    def e2e(name, unit, better, cell=None):
        m = {"name": name, "unit": unit, "better": better, "bound": 0.25, "source": "host_clock"}
        return m if cell is None else {**m, "workloads": [cell]}

    return {
        "configs": [{"name": "trackdrive-fsg", "file": "benchmark/configs/trackdrive-fsg.json", "reduced": []}],
        "workloads": [{"name": n, "config": "trackdrive-fsg", "traffic": n.split(".")[1], "chips": 1}
                      for n in NAMES],
        "end_to_end": [e2e("plan_ms_p50", "ms", "lower", ONLINE), e2e("plan_ms_p95", "ms", "lower", ONLINE),
                       e2e("solves_per_s", "solves/s", "higher", SWEEP), e2e("setup_s", "s", "lower")],
        "per_layer": [{"name": n, "unit": u, "better": b, "moves": _MOVES[cell], "workloads": [cell]}
                      for cell, rows in _PER_LAYER.items() for n, u, b in rows],
    }


def load(name: str):
    """The cell ``name``: a trackdrive cell from here, any other from
    BENCHMARK.json."""
    from harness import cell as cells

    return cells.load_cell(name, spec() if name in NAMES else None)
