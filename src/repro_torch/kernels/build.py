"""Build the port's CUDA kernels with ``nvcc`` on first use, load with ctypes.

The sources under ``csrc/`` have a plain C interface (no PyTorch headers),
so one ``nvcc`` call builds them into a shared library in seconds.  The
library goes to ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as is.  Every pointer and
the stream cross the boundary as ``c_void_p``; each launcher returns the
``cudaGetLastError()`` code of its launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "sched_argmin.cu",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    "e2c_masked_argmin": (_P, _P, _I, _I, _P, _P, _P),
    "e2c_fused_minmin": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    "e2c_fused_maxmin": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                         _P),
    "e2c_fused_start_pick": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    "e2c_fused_event_bounds": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
}

_lib: ctypes.CDLL | None = None
info: dict = {}     # what the last build did: library, seconds, compiler log


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source on first use and need the CUDA toolkit")


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsched_argmin_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources into the shared library unless it exists."""
    out = library_path()
    if out.exists():
        info.update(library=str(out), seconds=0.0, log="(cached)")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    info.update(library=str(out), seconds=seconds, command=" ".join(cmd),
                log=proc.stdout + proc.stderr)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.e2c_error_string.argtypes = [ctypes.c_int]
        lib.e2c_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if code != 0:
        msg = load().e2c_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({code}): {msg}")
