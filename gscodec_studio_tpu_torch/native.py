"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface. At first use each is compiled by
``nvcc`` for ``sm_90a`` (all started together), linked into one shared
library under ``_build/`` (git-ignored, named by a hash of the sources and
flags, so an edited source rebuilds) and loaded with ``ctypes``. Nothing
here includes PyTorch's headers: a wrapper passes ``data_ptr()`` values and
``torch.cuda.current_stream().cuda_stream`` as plain integers, and every C
entry returns ``cudaGetLastError()``, which :func:`check` turns into an
exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("pack.cu", "expand.cu", "raster_fwd.cu", "raster_bwd.cu",
           "unpack.cu", "segsum.cu", "raster_fwd_2dgs.cu",
           "raster_bwd_2dgs.cu", "raster_bwd_2dgs_absgrad.cu",
           "raster_v1_fwd.cu", "raster_v1_bwd.cu", "cumsum_rows.cu",
           "skel_composite.cu", "selective_adam.cu")
# included by the sources; in the hash
HEADERS = ("tile_common.cuh", "regions.cuh", "raster_bwd_2dgs.cuh",
           "raster_v1.cuh")
# --fmad=false: the kernels' float expressions round exactly as their plain
# PyTorch versions (and the JAX package) do, which keeps the expansion's
# ellipse cull bit-identical to its plain version. B2's gradient arithmetic
# asks for its multiply-adds explicitly (csrc/raster_bwd.cu madd).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "gsc_pack_rows": (_P, _P, _I, _P, _L, _P, _I, _P),
    "gsc_expand": (_P, _I, _P, _P, _P, _I, _P, _L, _I, _I, _I, _I, _I, _I,
                   _I, _P, _P, _P),
    "gsc_raster_fwd": (_P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _I, _I, _P, _P),
    "gsc_raster_bwd": (_P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, _I, _I, _I, _I, _I, _P, _P),
    "gsc_unpack_rows": (_P, _L, _I, _I, _P, _L, _P, _P, _P),
    "gsc_segsum_rows": (_P, _L, _I, _P, _I, _P, _I, _I, _P, _P, _P, _P),
    "gsc_raster_fwd_2dgs": (_P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _P, _P),
    "gsc_raster_bwd_2dgs": (_P, _L, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _P, _P),
    "gsc_raster_v1_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                          _P),
    "gsc_raster_v1_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _P, _P),
    "gsc_cumsum_rows": (_P, _I, _L, _P, _P, _P),
    "gsc_skel_composite": (_P, _L, _P, _P, _I, _P, _P),
    "gsc_selective_adam": (_P, _P, _P, _P, _P, _L, _I, _F, _F, _F, _F, _F,
                           _F, _P),
}

_lib = None
build_seconds = None  # wall time of the build this process ran, if any


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "gscodec_studio_tpu_torch's kernels")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libgsc_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if this version of the sources is not built yet;
    returns the library's path. The compiler's register and shared-memory
    report is kept beside it as ``<library>.log``."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    t0 = time.perf_counter()
    nvcc = _nvcc()
    work = BUILD_DIR / f"tmp_{out.stem}_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    objs = [work / (Path(s).stem + ".o") for s in SOURCES]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for s, o in zip(SOURCES, objs)
    ]
    logs = []
    for i, (s, proc) in enumerate(zip(SOURCES, procs)):
        text, _ = proc.communicate()
        logs.append(f"== {s}\n{text}")
        if proc.returncode != 0:
            # stop the rest and drain their pipes: a wait() alone blocks
            # forever on one whose report fills its pipe
            for other in procs[i + 1:]:
                other.kill()
                other.communicate()
            raise RuntimeError(f"nvcc failed on {s}:\n{text}")
    tmp_so = work / out.name
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp_so), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    Path(str(out) + ".log").write_text("\n".join(logs))
    os.replace(tmp_so, out)
    shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
