"""The host-side C++ helpers of the compression pipeline: PLAS, the 2D
grid sort (``csrc/host/plas.cpp``), and the rANS entropy coder
(``csrc/host/rans.cpp``: ``quantize_freqs``, ``rans_encode`` /
``rans_decode`` on one table, ``rans_encode_ctx`` / ``rans_decode_ctx``
on per-symbol context tables).

Built apart from the CUDA kernels (``gscodec_studio_tpu_torch/native.py``),
so that it runs where there is no CUDA toolkit: at first use ``g++``
compiles it into ``_build/`` (git-ignored), named by a hash of the source
and the flags, and it is loaded with ``ctypes``. The flags are the JAX
package's, so that both libraries sort alike on one machine and write
the same rANS bytes for the same symbols and tables.
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
SOURCES = ("plas.cpp", "rans.cpp")
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
            u8p = ctypes.POINTER(ctypes.c_uint8)
            u16p = ctypes.POINTER(ctypes.c_uint16)
            u32p = ctypes.POINTER(ctypes.c_uint32)
            u64p = ctypes.POINTER(ctypes.c_uint64)
            i64, cint = ctypes.c_int64, ctypes.c_int
            lib.plas_sort.restype = ctypes.c_int
            lib.plas_sort.argtypes = [
                f32p, i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_double, ctypes.c_uint64, ctypes.c_int,
            ]
            lib.rans_quantize_freqs.restype = None
            lib.rans_quantize_freqs.argtypes = [u64p, cint, u32p]
            lib.rans_encode_u8.restype = i64
            lib.rans_encode_u8.argtypes = [u8p, i64, u32p, cint, u8p, i64]
            lib.rans_decode_u8.restype = cint
            lib.rans_decode_u8.argtypes = [u8p, i64, u32p, cint, u8p, i64]
            lib.rans_encode_u8_ctx.restype = i64
            lib.rans_encode_u8_ctx.argtypes = [u8p, u16p, i64, u32p, cint,
                                               cint, u8p, i64]
            lib.rans_decode_u8_ctx.restype = cint
            lib.rans_decode_u8_ctx.argtypes = [u8p, i64, u16p, u32p, cint,
                                               cint, u8p, i64]
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


def quantize_freqs(counts: np.ndarray) -> np.ndarray:
    """Raw counts [nsym] -> a frequency table summing to 2^14, every
    nonzero count at least 1."""
    counts = np.ascontiguousarray(counts, np.uint64)
    out = np.zeros(len(counts), np.uint32)
    get_lib().rans_quantize_freqs(_as_ptr(counts, ctypes.c_uint64),
                                  len(counts), _as_ptr(out, ctypes.c_uint32))
    return out


def _encode_capacity(n: int) -> int:
    # up to ~30 bits a symbol when one lands in a 2^-30 tail of a context
    # table (an untrained conditional model), and the 8-byte state
    return n * 5 + 64


def rans_encode(symbols: np.ndarray, freqs: np.ndarray) -> bytes:
    """u8 symbols against one table (``quantize_freqs``'s) -> the stream."""
    symbols = np.ascontiguousarray(symbols, np.uint8)
    freqs = np.ascontiguousarray(freqs, np.uint32)
    cap = _encode_capacity(symbols.size)
    out = np.zeros(cap, np.uint8)
    n = get_lib().rans_encode_u8(
        _as_ptr(symbols, ctypes.c_uint8), symbols.size,
        _as_ptr(freqs, ctypes.c_uint32), len(freqs),
        _as_ptr(out, ctypes.c_uint8), cap)
    if n < 0:
        raise RuntimeError(f"rans_encode failed: {n}")
    return out[:n].tobytes()


def rans_decode(buf: bytes, freqs: np.ndarray, n: int) -> np.ndarray:
    """The n u8 symbols of a rans_encode stream."""
    arr = np.frombuffer(buf, np.uint8)
    freqs = np.ascontiguousarray(freqs, np.uint32)
    out = np.zeros(n, np.uint8)
    rc = get_lib().rans_decode_u8(
        _as_ptr(arr, ctypes.c_uint8), arr.size,
        _as_ptr(freqs, ctypes.c_uint32), len(freqs),
        _as_ptr(out, ctypes.c_uint8), n)
    if rc != 0:
        raise RuntimeError(f"rans_decode failed: {rc}")
    return out


def rans_encode_ctx(symbols: np.ndarray, ctx: np.ndarray,
                    freqs_2d: np.ndarray) -> bytes:
    """u8 symbols, each against the table of its context id: ctx [n]
    uint16 rows of freqs_2d [nctx, nsym]."""
    symbols = np.ascontiguousarray(symbols, np.uint8)
    ctx = np.ascontiguousarray(ctx, np.uint16)
    freqs_2d = np.ascontiguousarray(freqs_2d, np.uint32)
    nctx, nsym = freqs_2d.shape
    cap = _encode_capacity(symbols.size)
    out = np.zeros(cap, np.uint8)
    n = get_lib().rans_encode_u8_ctx(
        _as_ptr(symbols, ctypes.c_uint8), _as_ptr(ctx, ctypes.c_uint16),
        symbols.size, _as_ptr(freqs_2d, ctypes.c_uint32), nctx, nsym,
        _as_ptr(out, ctypes.c_uint8), cap)
    if n < 0:
        raise RuntimeError(f"rans_encode_ctx failed: {n}")
    return out[:n].tobytes()


def rans_decode_ctx(buf: bytes, ctx: np.ndarray, freqs_2d: np.ndarray,
                    n: int) -> np.ndarray:
    """The n u8 symbols of a rans_encode_ctx stream, given the same
    context ids and tables."""
    arr = np.frombuffer(buf, np.uint8)
    ctx = np.ascontiguousarray(ctx, np.uint16)
    freqs_2d = np.ascontiguousarray(freqs_2d, np.uint32)
    nctx, nsym = freqs_2d.shape
    out = np.zeros(n, np.uint8)
    rc = get_lib().rans_decode_u8_ctx(
        _as_ptr(arr, ctypes.c_uint8), arr.size, _as_ptr(ctx, ctypes.c_uint16),
        _as_ptr(freqs_2d, ctypes.c_uint32), nctx, nsym,
        _as_ptr(out, ctypes.c_uint8), n)
    if rc != 0:
        raise RuntimeError(f"rans_decode_ctx failed: {rc}")
    return out
