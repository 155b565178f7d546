"""ctypes binding of the C++ replay-session loader.

Counterpart of `ft_fsd_path_planning_tpu/native/loader.py`. The C++ loader
(``replay_loader.cpp``) parses a session JSON log straight into the packed
fixed-shape frame arrays. Its shared library is built with ``g++`` at first
use into ``build/native/`` at the repository root, keyed on a hash of the
source and the flags, so an edited source rebuilds and an unchanged one is
built once. A failed build or a failed parse raises; nothing falls back.
The pure-Python loader, with the same output bit for bit, runs only when
the caller asks for it by name (``engine="python"``).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from ft_fsd_path_planning_torch.device import resolve_device
from ft_fsd_path_planning_torch.models.planner import FrameInput

SRC = Path(__file__).resolve().parent / "replay_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
ENGINES = ("cpp", "python")

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def library_path() -> Path:
    key = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libreplay_loader-{key}.so"


def build() -> Path:
    """Build the shared library unless it is built already; returns its path.
    Raises when the compiler is missing or fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    try:
        proc = subprocess.run(
            [CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)], capture_output=True, text=True
        )
    except OSError as err:
        raise RuntimeError(f"cannot run the C++ compiler {CXX!r} to build {SRC.name}") from err
    if proc.returncode != 0:
        raise RuntimeError(f"{CXX} failed to build {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.rl_load_session.restype = ctypes.c_int
            lib.rl_load_session.argtypes = [
                ctypes.c_char_p,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
            ]
            _lib = lib
        return _lib


def _load_python(path: str, n_max: int, max_frames: int):
    """The same output layout in plain Python and NumPy."""
    data = json.loads(Path(path).read_text())[:max_frames]
    t = len(data)
    cones = np.zeros((t, n_max, 3), np.float32)
    cones[:, :, 2] = -1.0
    mask = np.zeros((t, n_max), np.uint8)
    positions = np.zeros((t, 2), np.float32)
    directions = np.zeros((t, 2), np.float32)
    for i, frame in enumerate(data):
        positions[i] = frame["car_position"][:2]
        directions[i] = frame["car_direction"][:2]
        slot = 0
        for cone_type, lst in enumerate(frame["slam_cones"]):
            arr = np.asarray(lst, np.float32).reshape(-1, 2)
            for p in arr:
                if slot >= n_max:
                    break
                cones[i, slot, :2] = p
                cones[i, slot, 2] = cone_type
                mask[i, slot] = 1
                slot += 1
    return cones, mask, positions, directions


def _load_cpp(path: str, n_max: int, max_frames: int):
    lib = _library()
    cones = np.zeros((max_frames, n_max, 3), np.float32)
    mask = np.zeros((max_frames, n_max), np.uint8)
    positions = np.zeros((max_frames, 2), np.float32)
    directions = np.zeros((max_frames, 2), np.float32)
    t = lib.rl_load_session(
        str(path).encode(),
        n_max,
        max_frames,
        cones.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        positions.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        directions.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if t < 0:
        raise RuntimeError(f"the C++ loader could not read or parse {path}")
    return cones[:t], mask[:t], positions[:t], directions[:t]


def load_session(path, n_max: int = 128, max_frames: int = 4096, engine: str = "cpp"):
    """Load a recorded session into packed frame arrays.

    Returns (cones (T, N, 3) f32 [x, y, color] with color -1 on padding,
    mask (T, N) u8, positions (T, 2) f32, directions (T, 2) f32). ``engine``
    is ``"cpp"`` (the C++ loader) or ``"python"``.
    """
    if n_max <= 0 or max_frames <= 0:
        raise ValueError(f"n_max={n_max} and max_frames={max_frames} must be positive")
    if engine == "cpp":
        return _load_cpp(path, n_max, max_frames)
    if engine == "python":
        return _load_python(path, n_max, max_frames)
    raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")


def replay_frames(cones, mask, positions, directions, device=None) -> FrameInput:
    """The arrays of :func:`load_session` as a FrameInput of (T, 1, ...)
    tensors on ``device``: T steps of a batch of one, what
    ``parallel.batch.replay_scan`` takes. Default ``cuda``; raises without a
    GPU unless ``device="cpu"``."""
    dev = resolve_device(device)
    return FrameInput(
        cones=torch.as_tensor(cones, device=dev)[:, None],
        mask=torch.as_tensor(mask.astype(bool), device=dev)[:, None],
        position=torch.as_tensor(positions, device=dev)[:, None],
        direction=torch.as_tensor(directions, device=dev)[:, None],
    )
