"""Build the port's CUDA kernels with ``nvcc`` on first use, load with ctypes.

The sources under ``csrc/`` have a plain C interface (no PyTorch headers),
so one ``nvcc`` call builds a source into a shared library in seconds.
Each source is its own library with its own flags:

* ``sched_argmin`` (the five dispatch and event-loop reductions, and an
  empty kernel that measures the launch floor) is built
  with ``--fmad=false``: its kernels are held bit for bit to their plain
  versions, so no multiply-add may be contracted;
* ``fma`` (the learned policies' multiply-add, ``__fmaf_rn`` over
  broadcast float32 operands) rounds once by construction and is held bit
  for bit to its plain version;
* ``flash_attention``, ``flash_attention_bwd`` (its backward) and
  ``grouped_matmul`` (the model kernels) are held to a tolerance, so they
  let ``nvcc`` contract multiply-adds into FMAs, which is both faster and
  one rounding closer to the exact product.

A library goes to ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of its source, the shared headers
(``csrc/*.cuh``) and its flags, so an edited source is rebuilt and an
unchanged one is loaded as is.  ``build_all``
starts one ``nvcc`` per missing library, all together, and waits for them.
Every pointer and the stream cross the boundary as ``c_void_p``; each
launcher returns the ``cudaGetLastError()`` code of its launch.
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
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L4 = ctypes.c_longlong * 4


class FmaGeom(ctypes.Structure):
    """``Geom`` of ``csrc/fma.cu``, passed by value: the output's element
    count and shape (leading axes padded with 1) and the element strides
    of the three operands on its axes (0 where broadcast)."""
    _fields_ = [("n", ctypes.c_longlong), ("shape", _L4), ("sx", _L4),
                ("sw", _L4), ("sa", _L4)]


LIBRARIES = {
    "sched_argmin": {
        "flags": COMMON_FLAGS + ("--fmad=false",),
        "signatures": {
            # values, mask, r, len, layout, idx, min, stream
            "e2c_masked_argmin": (_P, _P, _I, _I, _I, _P, _P, _P),
            # avail, in_batch, room, type_id, eet_m, r, n, m, t, layout,
            # idx, min, stream
            "e2c_fused_minmin": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                                 _P, _P),
            # avail, in_batch, room, type_id, eet_m, r, n, m, t, layout,
            # task, machine, score, stream
            "e2c_fused_maxmin": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                                 _P, _P, _P),
            # status, machine, seq, r, n, m, in_mq, layout, pick, has,
            # stream
            "e2c_fused_start_pick": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                                     _P),
            "e2c_fused_event_bounds": (_P, _P, _P, _I, _I, _I, _I, _I, _P,
                                       _P, _P),
            # an empty kernel: blocks, threads, stream
            "e2c_noop": (_I, _I, _P),
        },
    },
    "fma": {
        "flags": COMMON_FLAGS,
        "signatures": {
            # x, w, acc, out, geometry (by value), stream
            "e2c_fma": (_P, _P, _P, _P, FmaGeom, _P),
        },
    },
    "flash_attention": {
        "flags": COMMON_FLAGS,
        "signatures": {
            # q, k, v, o, scratch, lse (or null), bh, sq, sk, hd, causal,
            # window, scale, softcap, bf16, stream
            "e2c_flash_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, _F, _F, _I, _P),
            # bh, sq, sk, hd -> floats of scratch (long long)
            "e2c_flash_attention_scratch": (_I, _I, _I, _I),
        },
        "restypes": {"e2c_flash_attention_scratch": ctypes.c_longlong},
    },
    "flash_attention_bwd": {
        "flags": COMMON_FLAGS,
        "signatures": {
            # q, k, v, o, dout, lse, delta scratch, dq, dk, dv, bh, sq, sk,
            # hd, causal, window, scale, softcap, bf16, stream
            "e2c_flash_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                        _P, _I, _I, _I, _I, _I, _I, _F, _F,
                                        _I, _P),
        },
    },
    "grouped_matmul": {
        "flags": COMMON_FLAGS,
        "signatures": {
            # lhs, rhs, sizes, out, scratch, g, c, d, f, bf16, stream
            "e2c_grouped_matmul": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _P),
            # g, c, d, f -> floats of scratch (long long)
            "e2c_grouped_matmul_scratch": (_I, _I, _I, _I),
        },
        "restypes": {"e2c_grouped_matmul_scratch": ctypes.c_longlong},
    },
}

_libs: dict[str, ctypes.CDLL] = {}
info: dict[str, dict] = {}  # per library: path, seconds, command, log


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


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def library_path(name: str = "sched_argmin") -> Path:
    digest = hashlib.sha256(source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(LIBRARIES[name]["flags"]).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names=tuple(LIBRARIES)) -> dict[str, Path]:
    """Compile every named library that is not built yet, one ``nvcc``
    each, all started together; raise if any fails."""
    out = {name: library_path(name) for name in names}
    jobs = []
    for name, path in out.items():
        if path.exists():
            info.setdefault(name, dict(library=str(path), seconds=0.0,
                                       log="(cached)"))
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *LIBRARIES[name]["flags"], "-o", tmp,
               str(source(name))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, path, tmp, cmd, proc, time.perf_counter()))
    failed = []
    for name, path, tmp, cmd, proc, t0 in jobs:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, path)
        info[name] = dict(library=str(path), seconds=seconds,
                          command=" ".join(cmd), log=log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str = "sched_argmin") -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on the first call."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((name,))[name]))
        restypes = LIBRARIES[name].get("restypes", {})
        for fn_name, argtypes in LIBRARIES[name]["signatures"].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = restypes.get(fn_name, ctypes.c_int)
        lib.e2c_error_string.argtypes = [ctypes.c_int]
        lib.e2c_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(code: int, name: str, library: str = "sched_argmin") -> None:
    """Raise if a launcher of ``library`` reported a CUDA error."""
    if code != 0:
        msg = load(library).e2c_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({code}): {msg}")
