"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with :mod:`ctypes`; device code
that two sources share lives in a ``csrc/*.cuh`` header. Libraries live in
``build/kernels/`` at the repository root, keyed on a hash of the source,
the headers it includes and the flags, so an edited source or header
rebuilds what includes it and an unchanged one is built once. The build happens at first use (or up front through
:func:`build_all`, which starts one ``nvcc`` per source at once); a failed
build raises, there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: flags a source adds to NVCC_FLAGS. beam_search.cu, fitpack_part2.cu,
#: cone_matching.cu and path_parameterize.cu are held against plain
#: versions, which cannot fuse a product and a sum
EXTRA_FLAGS = {
    "beam_search": ("-fmad=false",), "fitpack_part2": ("-fmad=false",), "cone_matching": ("-fmad=false",),
    "path_parameterize": ("-fmad=false",),
}
#: the csrc/ headers a source includes, hashed into its library's key
HEADERS = {"banded_cholesky": ("banded_cholesky.cuh",), "fitpack_part2": ("banded_cholesky.cuh",)}

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def nvcc_flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join((CSRC / h).read_bytes() for h in HEADERS.get(name, ()))
    key = hashlib.sha256(src + " ".join(nvcc_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def ptxas_log_path(name: str) -> Path:
    return library_path(name).with_suffix(".ptxas.txt")


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    lib = library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *nvcc_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish_build(name: str, proc: subprocess.Popen, tmp: Path, lib: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}.cu:\n{log}")
    ptxas_log_path(name).write_text(log)
    os.replace(tmp, lib)


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Build every named kernel (default: every source in ``csrc/``), one
    ``nvcc`` per source, all started together. Returns the library paths."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        started = {n: _start_build(n) for n in names}
        for n, job in started.items():
            if job is not None:
                _finish_build(n, *job)
    return {n: library_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all([name])[name]
        with _lock:
            lib = _loaded.setdefault(name, ctypes.CDLL(str(path)))
    return lib
