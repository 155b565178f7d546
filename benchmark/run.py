"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs on the machine it is started on, on its first CUDA device, and refuses
to run without one. ``--trace 0`` measures the cell's end-to-end metrics
over a window of ``--seconds``; ``--trace 1`` runs a short traced window and
a staged pass and reports the per-layer metrics. Both then check every
answer (or a sample drawn from the seed) against the plain reference and
print, as the last line of standard output, one JSON object.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

#: top-level modules the measured process must not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "ft_fsd_path_planning_tpu")


def _caches_inside_checkout() -> None:
    cache = ROOT / "build" / "bench-cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _caches_inside_checkout()
    from harness import cell as cells

    cell = cells.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3

    from harness.runner import run_cell

    result = run_cell(cell, args, T0)
    found = forbidden_modules()
    if found:
        print(f"the measured process loaded {found}: refusing to report", file=sys.stderr)
        return 4
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
