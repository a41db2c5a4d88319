"""Build and load the port's hand-written CUDA kernels.

Every source under `csrc/` is compiled by its own `nvcc` process, all
started together, and the objects are linked into one shared library with a
plain C interface, at first use, into `build/torch_kernels/` (listed in
`.gitignore`), keyed by a hash of the sources, the headers they include and
the flags.  The wrappers (`ops/ilqr.py`, `ops/velocity_batch.py`,
`ops/cycle_tail.py`) call `load()` and set the ctypes signatures of the
entry points they use.  Nothing here runs at import
time, so importing the package needs no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(os.path.join(_PKG_DIR, "csrc", name) for name in ("ilqr.cu", "velocity.cu", "cycle_tail.cu"))
#: Headers the sources include: part of the library's hash, not compiled alone.
HEADERS = (os.path.join(_PKG_DIR, "csrc", "bicycle.cuh"),)
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_lib = None
#: nvcc's output from the build in this process ("" if the library was cached).
BUILD_LOG = ""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def load() -> ctypes.CDLL:
    """Compile every source (once per hash of sources, headers and flags; one nvcc
    process per source, in parallel), link them and load the library."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in SOURCES + HEADERS:
        with open(path, "rb") as fh:
            digest.update(fh.read())
    so = os.path.join(BUILD_DIR, f"lto_kernels_{digest.hexdigest()[:16]}.so")
    if not os.path.isfile(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        objs = [f"{tmp}.{os.path.basename(path)}.o" for path in SOURCES]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, path], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for path, obj in zip(SOURCES, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        link = None
        if all(proc.returncode == 0 for proc in procs):
            link = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs],
                                  capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        if link is None or link.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCES}:\n" + "".join(logs))
        BUILD_LOG = "".join(logs)
        os.replace(tmp, so)
    _lib = ctypes.CDLL(so)
    return _lib


def bind(lib: ctypes.CDLL, names, n_ptrs: int, n_ints: int, n_doubles: int = 0) -> None:
    """Set the ctypes signature of entry points that take `n_ptrs` device
    pointers, `n_ints` ints, `n_doubles` doubles and the stream, and return
    cudaError_t."""
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_double] * n_doubles + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
