"""The yardstick: the card's peaks, the operations and bytes each kernel of
the program needs, and the card's identity.

The counts are frozen copies of the program's `ops/beam_search.py::
search_flops`, `search_bytes` and `ops/banded_cholesky.py::solve_bytes`,
`refined_solve_flops` (with `solve_flops`), so that a change to a kernel
cannot move the bound it is held to. A test holds them equal to the
program's at the cells' shapes.
"""

from __future__ import annotations

import math
import subprocess

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_HBM_BYTES_PER_S = 3.35e12

# ---- kernel B2, the cone sorter's fused beam search ----------------------

_ATAN2_OPS = 30
_B2_PARAMS = 6


def b2_search_flops(k: int, l: int, c: int) -> int:
    """Float32 operations one search needs: gates, carries and score of every
    child, the score of every parent, and an exact top-K of the pool by
    comparison (``P * ceil(log2 P)`` compares)."""
    child = (
        2 * l + 22 + 10 + _ATAN2_OPS + 5 * c + 19 * c + 12 + _ATAN2_OPS + 6 + 8 + 60
        + 2 * (8 + _ATAN2_OPS) + 14 + 16
    )
    parent = 16 + 10 + _ATAN2_OPS + 12
    pool = k + k * c
    select = pool * math.ceil(math.log2(pool))
    return (l - 1) * (k * c * child + k * parent + select)


def b2_search_bytes(g: int, n: int, k: int, l: int, c: int) -> int:
    """Bytes one launch of ``g`` searches must move: each input read once,
    each output written once, float32."""
    state = (l + 16) * k + k
    return 4 * g * (n * 4 * c + state + _B2_PARAMS + state)


# ---- kernel B1, the banded Cholesky refined solve ------------------------

_HALF_BW = 4
_BW = 2 * _HALF_BW + 1


def b1_solve_bytes(b: int, c: int, r: int) -> int:
    """Bytes one launch of ``b`` systems must move: the band and the
    right-hand sides read once, the solution written once, float32."""
    return 4 * b * (c * _BW + 2 * c * r)


def b1_solve_flops(c: int, r: int) -> int:
    w = _HALF_BW
    flops = 0
    for i in range(c):
        flops += 2 * min(i, w) + 2
        for j in range(i + 1, min(i + w + 1, c)):
            flops += 2 * (i - max(j - w, 0)) + 1
    for i in range(c):
        flops += 2 * r * (2 * min(i, w) + 1)
    return flops


def b1_refined_solve_flops(c: int, r: int) -> int:
    """Operations of one refined solve: a factorisation, two pairs of
    substitutions, the banded residual and the final sum."""
    substitutions = sum(2 * r * (2 * min(i, _HALF_BW) + 1) for i in range(c))
    band_elements = sum(min(i, _HALF_BW) + 1 + min(c - 1 - i, _HALF_BW) for i in range(c))
    return b1_solve_flops(c, r) + substitutions + r * (2 * band_elements + 2 * c)


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def card_info(index: int = 0) -> dict:
    """The card's name (as torch reports it) and its power limit in watts."""
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    limit = smi.splitlines()[index].rsplit(",", 1)[1].strip().split()[0]
    return {"kind": torch.cuda.get_device_name(index), "power_limit_w": float(limit)}
