"""Readings the limits of `correct` are set from: the program as it runs,
and its control, over many seeds in one process.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 --seconds 10 [--variant tf32]

For each seed it builds the cell's loop, runs its window (as a run does:
whole skidpad runs or laps until ``--seconds`` have passed), and prints one
JSON line with the numbers the check compares. The variant
``sound`` runs the program as the configuration states it (float32, TF32
off); ``tf32`` is the control: the program with its float32 products on
TF32 tensor cores, the nearest precision below the one the configuration
states. The benchmark's runs never run this file.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
#: every number the check can compare, read whether or not a limit holds it
READINGS = (
    "path_gap_m", "path_gap_p50_m", "curvature_gap_per_m", "curvature_gap_p50_per_m",
    "unanswered", "reference_fallbacks",
)
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--variant", choices=("sound", "tf32"), default="sound")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from harness import cell as cells
    from harness import check

    import ft_fsd_path_planning_torch  # noqa: F401  (sets TF32 off on import)

    if args.variant == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
    cell = cells.load_cell(args.workload)
    limits = dict.fromkeys(READINGS, float("inf"))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        loop = cells.loop_module(cell).Loop(cell, seed, cells.track_module(cell), args.device)
        loop.setup()
        elapsed = loop.window(args.seconds)
        loop.finish()
        _, report = check.compare(loop, limits, np.random.default_rng([seed, 1]))
        print(json.dumps({
            "workload": args.workload, "variant": args.variant, "seed": seed,
            "answers": loop.attempted, "failed": loop.failed, "window_s": elapsed,
            "run_s": time.perf_counter() - t0,
            "numbers": {k: v["value"] for k, v in report.items()},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
