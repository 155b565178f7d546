"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` argument they take ``cuda``, and without a CUDA device they raise
rather than fall back.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev
