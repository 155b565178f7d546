"""Batched banded SPD solve — kernel B1 of the port.

Counterpart of `ft_fsd_path_planning_tpu/ops/pallas/banded_cholesky.py` and
of the refinement `ft_fsd_path_planning_tpu/ops/spline.py::_banded_solve`
builds on it. The TPU kernel becomes the CUDA kernel
`csrc/banded_cholesky.cu`, which has two entries:

* the bare solve (:func:`banded_cholesky_solve`), the TPU kernel's own
  function: band (B, C, 9), rhs (B, C, R) -> x;
* the refined solve from the dense matrix
  (:func:`banded_refined_solve_cuda`), what the spline engine needs: one
  launch reads the nine diagonals of the dense (B, C, C) matrix, factors
  once, solves, forms the residual and solves again with the same factor.
  `ops/spline.py::_solve_spd_banded` takes it for CUDA tensors and the same
  arithmetic composed of the band helpers for CPU tensors.

Beside each entry stands its plain PyTorch version (the same arithmetic in
the same order, written over the batch axis). :func:`banded_cholesky_solve`
takes the plain version only for tensors on the CPU. For a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ft_fsd_path_planning_torch.ops import kernel_build

Tensor = torch.Tensor

HALF_BW = 4
BW = 2 * HALF_BW + 1  # 9
#: what the kernel takes: C is a run-time value up to MAX_COEFS (a system then
#: fills 5.5 KB of shared memory), R is a template parameter. The FITPACK
#: main path has C = NC = 28 and R = 2 (x and y)
MAX_COEFS = 64
KERNEL_RHS = (1, 2)

#: launches of the CUDA kernel since the last reset, through either entry
#: (plain calls do not count), and those of each entry
launch_count = 0
bare_launch_count = 0
refined_launch_count = 0


def reset_launch_count() -> None:
    global launch_count, bare_launch_count, refined_launch_count
    launch_count = bare_launch_count = refined_launch_count = 0


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


def banded_refined_solve_plain(a: Tensor, rhs: Tensor) -> Tensor:
    """The fused entry's arithmetic in plain PyTorch: dense a (B, C, C), rhs
    (B, C, R) -> x. The band of ``a`` is solved, the residual formed with
    :func:`band_matvec`, solved again and the correction added."""
    band = dense_to_band(a)
    x = banded_cholesky_solve_plain(band, rhs)
    resid = rhs - band_matvec(band, x)
    return x + banded_cholesky_solve_plain(band, resid)


def _check_cuda(name: str, a: Tensor, rhs: Tensor, width: int | None) -> tuple[int, int, int]:
    """Refuse what the kernel does not take: ``a`` is (B, C, width), or
    (B, C, C) where ``width`` is None. Returns (B, C, R)."""
    if a.device.type != "cuda" or rhs.device != a.device:
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if a.dtype != torch.float32 or rhs.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 tensors")
    if a.dim() != 3 or rhs.dim() != 3:
        raise ValueError(f"{name}: the matrix must be (B, C, {width or 'C'}) and rhs (B, C, R)")
    b, c, last = a.shape
    if last != (width or c) or rhs.shape[:2] != (b, c):
        raise ValueError(f"shape mismatch: matrix {tuple(a.shape)}, rhs {tuple(rhs.shape)}")
    r = rhs.shape[2]
    if not 1 <= c <= MAX_COEFS or r not in KERNEL_RHS:
        raise ValueError(f"the kernel takes C <= {MAX_COEFS} and R in {KERNEL_RHS}, got (C, R) = {(c, r)}")
    if not rhs.is_contiguous():
        raise ValueError("rhs must be contiguous")
    return b, c, r


def _launched(err: int, entry: str) -> None:
    global launch_count
    if err != 0:
        raise RuntimeError(f"banded_cholesky kernel ({entry}) launch failed: CUDA error {err}")
    launch_count += 1


def banded_cholesky_solve_cuda(band: Tensor, rhs: Tensor) -> Tensor:
    """Launch the kernel's bare entry on the current stream (no synchronisation)."""
    global bare_launch_count
    b, c, r = _check_cuda("banded_cholesky_solve_cuda", band, rhs, BW)
    if not band.is_contiguous():
        raise ValueError("band must be contiguous")
    out = torch.empty_like(rhs)
    if b == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(band.device).cuda_stream
    with torch.cuda.device(band.device):
        err = lib.banded_cholesky_solve_f32(
            band.data_ptr(), rhs.data_ptr(), out.data_ptr(), b, c, r, stream
        )
    _launched(err, "bare")
    bare_launch_count += 1
    return out


def banded_refined_solve_cuda(a: Tensor, rhs: Tensor) -> Tensor:
    """Launch the kernel's fused entry on the current stream (no
    synchronisation): dense a (B, C, C) with any strides, rhs (B, C, R)."""
    global refined_launch_count
    b, c, r = _check_cuda("banded_refined_solve_cuda", a, rhs, None)
    out = torch.empty_like(rhs)
    if b == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = lib.banded_refined_solve_dense_f32(
            a.data_ptr(), *a.stride(), rhs.data_ptr(), out.data_ptr(), b, c, r, stream
        )
    _launched(err, "fused")
    refined_launch_count += 1
    return out


def empty_launch_cuda(batch: int, device: torch.device) -> None:
    """Launch an empty kernel on the grid a solve of ``batch`` systems has:
    the floor any single launch has on this card. Counts as no launch of B1."""
    lib = _library()
    with torch.cuda.device(device):
        err = lib.banded_empty_launch(batch, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel's library with its C interface declared, built and bound once."""
    lib = kernel_build.load("banded_cholesky")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.banded_cholesky_solve_f32.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.banded_refined_solve_dense_f32.argtypes = [ptr, i64, i64, i64, ptr, ptr, i32, i32, i32, ptr]
    lib.banded_empty_launch.argtypes = [i32, ptr]
    for fn in (lib.banded_cholesky_solve_f32, lib.banded_refined_solve_dense_f32, lib.banded_empty_launch):
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


def solve_bytes(b: int, c: int, r: int) -> int:
    """Bytes either entry must move: the band elements and the right-hand
    sides read once, the solution written once, float32. The dense entry
    needs no more: of the (C, C) matrix only the band counts."""
    return 4 * b * (c * BW + 2 * c * r)


def refined_solve_flops(c: int, r: int) -> int:
    """Floating-point operations of one refined solve: one factorisation and
    two pairs of substitutions (:func:`solve_flops` counts one of each), the
    residual (a product and a sum per band element and right-hand side, one
    difference per entry) and the final sum."""
    substitutions = sum(2 * r * (2 * min(i, HALF_BW) + 1) for i in range(c))
    band_elements = sum(min(i, HALF_BW) + 1 + min(c - 1 - i, HALF_BW) for i in range(c))
    return solve_flops(c, r) + substitutions + r * (2 * band_elements + 2 * c)


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
