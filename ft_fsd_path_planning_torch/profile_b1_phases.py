"""Where the cycles of one launch of kernel B1 go on the card.

    python -m ft_fsd_path_planning_torch.profile_b1_phases [--batch 256] [--coefs 28]

Builds ``csrc/banded_cholesky.cu`` with ``-DB1_PHASE_CLOCKS``, which makes
block 0 stamp ``clock64()`` at the end of each phase, launches the bare and
the fused entry on seeded SPD systems with two right-hand sides, and prints
one JSON line: the cycles each phase took (of the third launch, caches
warm), the SM clock, and whether the results equal the plain versions.
Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from ft_fsd_path_planning_torch.ops import banded_cholesky as bc
from ft_fsd_path_planning_torch.ops import kernel_build

PHASES = (
    "copies issued", "copies arrived", "factor and forward substitution", "back substitution",
    "residual", "forward substitution 2", "back substitution 2", "store",
)
BARE_PHASES = (0, 1, 2, 3, 7)  # the bare entry stops after the first back substitution


def build() -> ctypes.CDLL:
    kernel_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = kernel_build.BUILD_DIR / "libbanded_cholesky-phase-clocks.so"
    cmd = [
        kernel_build._nvcc(), *kernel_build.nvcc_flags("banded_cholesky"), "-DB1_PHASE_CLOCKS",
        "-o", str(lib), str(kernel_build.CSRC / "banded_cholesky.cu"),
    ]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--coefs", type=int, default=28)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_b1_phases needs a CUDA device")

    lib = build()
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.banded_cholesky_solve_f32.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.banded_refined_solve_dense_f32.argtypes = [ptr, i64, i64, i64, ptr, ptr, i32, i32, i32, ptr]

    b, c, r = args.batch, args.coefs, 2
    rng = np.random.default_rng(0)
    low = np.zeros((b, c, c))
    for off in range(bc.HALF_BW + 1):
        idx = np.arange(c - off)
        low[:, idx + off, idx] = rng.normal(size=(b, c - off)) * (1.0 if off == 0 else 0.3)
    dense = torch.tensor(low @ low.transpose(0, 2, 1) + 0.5 * np.eye(c), dtype=torch.float32, device="cuda")
    rhs = torch.tensor(rng.normal(size=(b, c, r)), dtype=torch.float32, device="cuda")
    band = bc.dense_to_band(dense).contiguous()
    out = torch.empty_like(rhs)
    stream = torch.cuda.current_stream().cuda_stream
    stamps = (ctypes.c_longlong * 9)()

    def cycles(launch, kept) -> dict:
        for _ in range(3):
            err = launch()
            torch.cuda.synchronize()
            if err != 0 or lib.banded_read_phase_clocks(stamps) != 0:
                raise RuntimeError(f"launch or read-back failed: CUDA error {err}")
        t = list(stamps)
        ends = [t[k + 1] for k in kept]
        return {PHASES[k]: end - start for k, start, end in zip(kept, [t[0]] + ends[:-1], ends)} | {"all": ends[-1] - t[0]}

    bare = cycles(lambda: lib.banded_cholesky_solve_f32(band.data_ptr(), rhs.data_ptr(), out.data_ptr(), b, c, r, stream), BARE_PHASES)
    bare_equal = bool(torch.equal(out, bc.banded_cholesky_solve_plain(band, rhs)))
    fused = cycles(
        lambda: lib.banded_refined_solve_dense_f32(dense.data_ptr(), *dense.stride(), rhs.data_ptr(), out.data_ptr(), b, c, r, stream),
        range(len(PHASES)),
    )
    fused_equal = bool(torch.equal(out, bc.banded_refined_solve_plain(dense, rhs)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({
        "device": smi, "shape": [b, c, r], "cycles_bare": bare, "cycles_fused": fused,
        "bare_equals_plain": bare_equal, "fused_equals_plain": fused_equal,
    }), flush=True)


if __name__ == "__main__":
    main()
