"""A run of the harness on the CPU at a tiny size, for the tests: the plain
PyTorch path of the program, a window of a few frames, the check. Never a
measurement. Prints the result object and the forbidden modules loaded."""

import json
import sys
import time
import types
from pathlib import Path

T0 = time.perf_counter()
BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


#: the window drives whole runs or laps: short ones here, so that a dry run
#: on the CPU ends in seconds
TINY = {
    "trackdrive.online": {"closed_track": {"frames_per_lap": 10, "jitter_m": 0.02}},
    "skidpad.online": {"skidpad": {"stride": 200}},
}


def dry_run(workload: str, seed: int, seconds: float, **traffic) -> dict:
    from harness.runner import run_cell
    from trackdrive_cells import load

    cell = load(workload)
    cell.traffic.update(TINY.get(workload, {}), **traffic)
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=0)
    return run_cell(cell, args, T0, "cpu")


if __name__ == "__main__":
    import run

    result = dry_run(sys.argv[1], int(sys.argv[2]), float(sys.argv[3]), **json.loads(sys.argv[4]))
    print(json.dumps({"result": result, "forbidden": run.forbidden_modules()}))
