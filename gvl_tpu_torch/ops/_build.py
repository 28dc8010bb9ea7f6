"""Builds the port's CUDA kernels with nvcc into a shared library with a plain
C interface, loaded with ctypes.

The library is built at first use into `build/kernels/` at the repository
root, named by a hash of its sources and flags, so a checkout builds it once
and a changed source builds anew. Nothing here runs at import time: this
module is imported on machines without nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

_ROOT = Path(__file__).resolve().parents[2]
_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = _ROOT / "build" / "kernels"
SOURCES = ("ms_deform_attn_fwd.cu", "ms_deform_attn_bwd.cu",
           "ms_deform_attn_banded_fwd.cu", "ms_deform_attn_banded_bwd.cu")
HEADERS = ("ms_deform_attn_common.cuh",       # included by the sources
           "ms_deform_attn_banded.cuh")
# --threads 0: the sources compile side by side, one job per core
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "--threads", "0")


class Built(NamedTuple):
    path: Path
    seconds: float      # nvcc wall time; 0.0 when the library was already built
    log: str            # nvcc's output (ptxas register/spill report)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        return str(Path(cuda_home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build() -> Built:
    """Compile the kernels for sm_90a unless a library of the same sources and
    flags exists. Raises CalledProcessError with nvcc's output on failure."""
    srcs = [_CSRC / s for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + [_CSRC / name for name in HEADERS]:
        h.update(s.read_bytes())
    out = BUILD_DIR / f"libgvl_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return Built(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise subprocess.CalledProcessError(proc.returncode, cmd,
                                            proc.stdout, proc.stderr)
    os.replace(tmp, out)
    return Built(out, seconds, proc.stdout + proc.stderr)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build().path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.msda_fwd_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                 ctypes.POINTER(ctypes.c_int), p]
    lib.msda_fwd_f32.restype = i
    lib.msda_fwd_bf16taps.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                      ctypes.POINTER(ctypes.c_int), i, i, p]
    lib.msda_fwd_bf16taps.restype = i
    lib.msda_bwd_f32.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                 ctypes.POINTER(ctypes.c_int), i, i, i, p]
    lib.msda_bwd_f32.restype = i
    lib.msda_taps_fwd_f32.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                                      p]
    lib.msda_taps_fwd_f32.restype = i
    lib.msda_taps_bwd_f32.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i,
                                      i, i, i, i, i, i, p]
    lib.msda_taps_bwd_f32.restype = i
    ints = ctypes.POINTER(ctypes.c_int)
    lib.msda_banded_fwd_f32.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                        ints, ints, i, p]
    lib.msda_banded_fwd_f32.restype = i
    lib.msda_banded_fwd_bf16taps.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                             ints, ints, i, i, i, p]
    lib.msda_banded_fwd_bf16taps.restype = i
    lib.msda_banded_bwd_f32.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                                        ints, ints, ints, i, p]
    lib.msda_banded_bwd_f32.restype = i
    return lib
