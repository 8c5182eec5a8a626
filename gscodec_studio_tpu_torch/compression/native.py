"""The host-side C++ helpers of the compression pipeline: PLAS, the 2D
grid sort (``csrc/host/plas.cpp``).

Built apart from the CUDA kernels (``gscodec_studio_tpu_torch/native.py``),
so that it runs where there is no CUDA toolkit: at first use ``g++``
compiles it into ``_build/`` (git-ignored), named by a hash of the source
and the flags, and it is loaded with ``ctypes``. The flags are the JAX
package's, so that both libraries sort alike on one machine.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

HOST_CSRC = Path(__file__).resolve().parents[1] / "csrc" / "host"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("plas.cpp",)
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for name in SOURCES:
        h.update((HOST_CSRC / name).read_bytes())
    return BUILD_DIR / f"libgsc_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the host library if this version is not built yet; returns
    its path. Several processes may build at once: each writes its own
    file and renames it into place."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        ["g++", *GXX_FLAGS, "-o", str(tmp),
         *(str(HOST_CSRC / s) for s in SOURCES), "-lpthread"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCES}:\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded host library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            f32p = ctypes.POINTER(ctypes.c_float)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.plas_sort.restype = ctypes.c_int
            lib.plas_sort.argtypes = [
                f32p, i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_double, ctypes.c_uint64, ctypes.c_int,
            ]
            _LIB = lib
        return _LIB


def _as_ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def plas_sort(data: np.ndarray, grid: int, sweeps_per_level: int = 2,
              radius_decay: float = 0.7, seed: int = 0,
              n_threads: int = 0) -> np.ndarray:
    """Self-organizing 2D grid sort: data [grid*grid, d] -> perm
    [grid*grid] with perm[pos] = source row. ``n_threads`` 0 takes every
    core; only 1 gives the same permutation on every run."""
    data = np.ascontiguousarray(data, np.float32)
    n, d = data.shape
    if n != grid * grid:
        raise ValueError(f"plas_sort: {n} rows for a {grid}x{grid} grid")
    perm = np.zeros(n, np.int32)
    rc = get_lib().plas_sort(
        _as_ptr(data, ctypes.c_float), _as_ptr(perm, ctypes.c_int32),
        grid, d, sweeps_per_level, radius_decay, seed, n_threads)
    if rc != 0:
        raise RuntimeError(f"plas_sort failed: {rc}")
    return perm

