"""Lookup primitives with the JAX package's fill semantics.

`ft_fsd_path_planning_tpu/ops/gatherless.py` writes every dynamic lookup as a
one-hot contraction, because general gathers are slow on a TPU. On the GPU a
gather is the natural form, so these are plain indexing. What is kept is the
behaviour at the edges: an index outside ``[0, n)`` reads a zero (or
``fill``) row, exactly as the one-hot contraction does, instead of raising
on the CPU or asserting on the device.

All functions are batched: leading axes of ``table``/``arr`` and of the
index tensors are shared batch axes.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _in_range(idx: Tensor, n: int) -> tuple[Tensor, Tensor]:
    ok = (idx >= 0) & (idx < n)
    return idx.clamp(0, n - 1), ok


def take_rows(table: Tensor, idx: Tensor, fill: float = 0.0) -> Tensor:
    """table (..., N, F), idx (..., K) int -> (..., K, F); rows of
    out-of-range indices (e.g. -1 padding) are ``fill``."""
    safe, ok = _in_range(idx, table.shape[-2])
    out = torch.take_along_dim(table, safe[..., None].long(), dim=-2)
    return torch.where(ok[..., None], out, torch.full_like(out, fill))


def take_vec(values: Tensor, idx: Tensor, fill: float = 0.0) -> Tensor:
    """values (..., N), idx (..., K) int -> (..., K); out-of-range -> fill."""
    safe, ok = _in_range(idx, values.shape[-1])
    out = torch.take_along_dim(values, safe.long(), dim=-1)
    return torch.where(ok, out, torch.full_like(out, fill))


def _shift(arr: Tensor, src: Tensor, fill: float) -> Tensor:
    """out[b, i] = arr[b, src[b, i]] for src in range, else fill (axis 1)."""
    n = arr.shape[1]
    safe, ok = _in_range(src, n)
    extra = arr.shape[2:]
    index = safe.long().reshape(safe.shape + (1,) * len(extra)).expand(safe.shape + extra)
    out = torch.gather(arr, 1, index)
    ok = ok.reshape(ok.shape + (1,) * len(extra))
    return torch.where(ok, out, torch.full_like(out, fill))


def shift_left(arr: Tensor, k: Tensor, fill: float = 0.0) -> Tensor:
    """arr (B, N, ...), k (B,) in [0, N]: out[i] = arr[i + k] for i + k < N,
    else fill."""
    n = arr.shape[1]
    src = torch.arange(n, device=arr.device)[None, :] + k[:, None]
    return _shift(arr, src, fill)


def shift_right(arr: Tensor, k: Tensor, fill: float = 0.0) -> Tensor:
    """arr (B, N, ...), k (B,) in [0, N]: out[i] = arr[i - k] for i >= k,
    else fill."""
    n = arr.shape[1]
    src = torch.arange(n, device=arr.device)[None, :] - k[:, None]
    return _shift(arr, src, fill)


def window(arr: Tensor, start: Tensor, size: int, fill: float = 0.0) -> Tensor:
    """arr (B, N, ...), start (B,): rows [start, start + size), fill outside
    [0, N)."""
    src = start[:, None] + torch.arange(size, device=arr.device)[None, :]
    return _shift(arr, src, fill)


def circular_roll(arr: Tensor, s: Tensor) -> Tensor:
    """arr (B, N, ...), s (B,) in [0, N]: out[i] = arr[(i + s) mod N]."""
    n = arr.shape[1]
    src = torch.remainder(torch.arange(n, device=arr.device)[None, :] + s[:, None], n)
    return _shift(arr, src, 0.0)


def select_slot(values: Tensor, slot: Tensor) -> Tensor:
    """values (..., K, C, V), slot (..., K) int in [0, C) -> (..., K, V)."""
    safe, ok = _in_range(slot, values.shape[-2])
    out = torch.take_along_dim(values, safe[..., None, None].long(), dim=-2)[..., 0, :]
    return torch.where(ok[..., None], out, torch.zeros_like(out))
