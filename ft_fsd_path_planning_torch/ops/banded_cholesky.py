"""Batched banded SPD solve — kernel B1 of the port.

Counterpart of `ft_fsd_path_planning_tpu/ops/pallas/banded_cholesky.py`. The
TPU kernel becomes the CUDA kernel `csrc/banded_cholesky.cu`; this module
holds its wrapper, its plain PyTorch version (the same row recurrence
written over the batch axis) and the band helpers.

:func:`banded_cholesky_solve` takes the plain version only for tensors on
the CPU. For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ft_fsd_path_planning_torch.ops import kernel_build

Tensor = torch.Tensor

HALF_BW = 4
BW = 2 * HALF_BW + 1  # 9
#: (C, R) pairs the kernel is instantiated for: the FITPACK main path
#: (C = NC = 28, x and y) and the two test shapes
KERNEL_SHAPES = ((28, 2), (51, 2), (20, 1))

#: launches of the CUDA kernel since the last reset (plain calls do not count)
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def banded_cholesky_solve_plain(band: Tensor, rhs: Tensor) -> Tensor:
    """The kernel's arithmetic in plain PyTorch: band (B, C, 9), rhs
    (B, C, R) -> x (B, C, R)."""
    _, c, bw = band.shape
    if bw != BW:
        raise ValueError(f"band must have {BW} columns, got {bw}")
    w = HALF_BW
    l_rows = [[None] * (w + 1) for _ in range(c)]
    inv_diag = [None] * c
    for i in range(c):
        acc = band[:, i, w]
        for d in range(w):
            if i - w + d >= 0:
                acc = acc - l_rows[i][d] * l_rows[i][d]
        diag = torch.sqrt(torch.clamp(acc, min=1e-20))
        l_rows[i][w] = diag
        inv_diag[i] = 1.0 / diag
        for j in range(i + 1, min(i + w + 1, c)):
            acc = band[:, j, w - (j - i)]
            for k in range(max(j - w, 0), i):
                acc = acc - l_rows[j][k - (j - w)] * l_rows[i][k - (i - w)]
            l_rows[j][i - (j - w)] = acc * inv_diag[i]

    y = [None] * c
    for i in range(c):
        acc = rhs[:, i, :]
        for k in range(max(i - w, 0), i):
            acc = acc - l_rows[i][k - (i - w)][:, None] * y[k]
        y[i] = acc * inv_diag[i][:, None]

    x = [None] * c
    for i in range(c - 1, -1, -1):
        acc = y[i]
        for j in range(i + 1, min(i + w + 1, c)):
            acc = acc - l_rows[j][i - (j - w)][:, None] * x[j]
        x[i] = acc * inv_diag[i][:, None]
    return torch.stack(x, dim=1)


def banded_cholesky_solve_cuda(band: Tensor, rhs: Tensor) -> Tensor:
    """Launch the CUDA kernel on the current stream (no synchronisation)."""
    global launch_count
    if band.device.type != "cuda" or rhs.device != band.device:
        raise ValueError("banded_cholesky_solve_cuda takes CUDA tensors on one device")
    if band.dtype != torch.float32 or rhs.dtype != torch.float32:
        raise TypeError("banded_cholesky_solve_cuda takes float32 tensors")
    if band.dim() != 3 or rhs.dim() != 3:
        raise ValueError("band must be (B, C, 9) and rhs (B, C, R)")
    b, c, bw = band.shape
    if bw != BW or rhs.shape[:2] != (b, c):
        raise ValueError(f"shape mismatch: band {tuple(band.shape)}, rhs {tuple(rhs.shape)}")
    r = rhs.shape[2]
    if (c, r) not in KERNEL_SHAPES:
        raise ValueError(f"no kernel instantiation for (C, R) = {(c, r)}; have {KERNEL_SHAPES}")
    if not (band.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("band and rhs must be contiguous")
    out = torch.empty_like(rhs)
    if b == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(band.device).cuda_stream
    with torch.cuda.device(band.device):
        err = lib.banded_cholesky_solve_f32(
            band.data_ptr(), rhs.data_ptr(), out.data_ptr(), b, c, r, stream
        )
    if err != 0:
        raise RuntimeError(f"banded_cholesky kernel launch failed: CUDA error {err}")
    launch_count += 1
    return out


def _library() -> ctypes.CDLL:
    lib = kernel_build.load("banded_cholesky")
    fn = lib.banded_cholesky_solve_f32
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def banded_cholesky_solve(band: Tensor, rhs: Tensor) -> Tensor:
    """Solve SPD banded systems batched over the leading axis.

    band (B, C, 9) with band[b, i, d] = A[i, i - 4 + d] (zeros outside),
    rhs (B, C, R) -> (B, C, R). CPU tensors take the plain version; CUDA
    tensors the kernel."""
    if band.device.type == "cpu":
        return banded_cholesky_solve_plain(band, rhs)
    return banded_cholesky_solve_cuda(band, rhs)


def solve_flops(c: int, r: int) -> int:
    """Floating-point operations of one solve as the recurrence does them
    (multiply, subtract, square root and division each count one)."""
    w = HALF_BW
    flops = 0
    for i in range(c):
        flops += 2 * min(i, w) + 2  # pivot: products and differences, sqrt, 1/x
        for j in range(i + 1, min(i + w + 1, c)):
            flops += 2 * (i - max(j - w, 0)) + 1
    for i in range(c):  # forward and back substitution
        flops += 2 * r * (2 * min(i, w) + 1)
    return flops


def dense_to_band(a: Tensor) -> Tensor:
    """(..., C, C) banded matrix -> (..., C, 9) band storage, built from the
    nine diagonals: band[..., i, d] = a[..., i, i - 4 + d], zero outside."""
    lead = a.shape[:-2]
    cols = []
    for d in range(BW):
        off = d - HALF_BW
        diag = torch.diagonal(a, offset=off, dim1=-2, dim2=-1)
        pad = torch.zeros(lead + (abs(off),), dtype=a.dtype, device=a.device)
        cols.append(torch.cat([diag, pad] if off >= 0 else [pad, diag], dim=-1))
    return torch.stack(cols, dim=-1)


def band_matvec(band: Tensor, x: Tensor) -> Tensor:
    """(G, C, 9) banded matrix times (G, C, R): y[i] = sum_d band[i, d] x[i - 4 + d]."""
    _, c, bw = band.shape
    half = (bw - 1) // 2
    y = torch.zeros_like(x)
    for d in range(bw):
        off = d - half
        lo, hi = max(0, -off), c - max(0, off)
        y[:, lo:hi] += band[:, lo:hi, d, None] * x[:, lo + off : hi + off]
    return y
