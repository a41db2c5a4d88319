"""ctypes bindings of the host-side geometry in `native/lto_geometry.cpp` —
port of `lap_time_optimization_tpu/utils/native.py`.

The C++ source stays where it is in the repo; at first use it is compiled
with g++ into `build/native/` (listed in `.gitignore`), keyed by a hash of
the source and the flags.  Both entry points have a numpy version beside
them, used when no compiler is at hand, and the two give the same numbers
(tests/test_torch_corners.py).  Which one ran is logged once.  This is
setup geometry on the host, not a kernel of the device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "lto_geometry.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
FLAGS = ("-O3", "-fPIC", "-shared")
_log = logging.getLogger(__name__)
_lib = None
_tried = False


def _build() -> str | None:
    """Compile the source (with OpenMP where the toolchain has it) unless a
    library of the same source and flags exists; the path, or None."""
    if not os.path.isfile(SOURCE):
        return None
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"liblto_geometry_{digest}.so")
    if os.path.isfile(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    for extra in (["-fopenmp"], []):
        try:
            subprocess.run(["g++", *FLAGS, *extra, "-o", tmp, SOURCE], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            continue
        os.replace(tmp, so)
        return so
    return None


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = _build()
    if path is not None:
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            lib = None
        if lib is not None:
            dp, i64 = ctypes.POINTER(ctypes.c_double), ctypes.c_int64
            lib.lto_nearest_distances.argtypes = [dp, dp, i64, dp, dp, i64, dp]
            lib.lto_filter_corners.argtypes = [ctypes.POINTER(ctypes.c_uint8), dp, i64,
                                               ctypes.c_double, ctypes.c_double]
            _lib = lib
    _log.info("host geometry: %s", f"native ({path})" if _lib is not None else "numpy")
    return _lib


def available() -> bool:
    return _load() is not None


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def nearest_distances_numpy(path_xy: np.ndarray, boundary_xy: np.ndarray) -> np.ndarray:
    """min distance from each path point (2, n) to the boundary samples (2,
    m), pairwise in chunks that bound the memory."""
    n, m = path_xy.shape[1], boundary_xy.shape[1]
    out = np.empty(n, dtype=np.float64)
    chunk = max(1, 2_000_000 // max(m, 1))
    for i in range(0, n, chunk):
        dx = path_xy[0, i:i + chunk, None] - boundary_xy[0][None, :]
        dy = path_xy[1, i:i + chunk, None] - boundary_xy[1][None, :]
        out[i:i + chunk] = np.sqrt(np.min(dx * dx + dy * dy, axis=1))
    return out


def nearest_distances(path_xy: np.ndarray, boundary_xy: np.ndarray) -> np.ndarray:
    """min distance from each path point (2, n) to the boundary samples (2, m)."""
    path_xy = np.ascontiguousarray(path_xy, dtype=np.float64)
    boundary_xy = np.ascontiguousarray(boundary_xy, dtype=np.float64)
    lib = _load()
    if lib is None:
        return nearest_distances_numpy(path_xy, boundary_xy)
    n, m = path_xy.shape[1], boundary_xy.shape[1]
    out = np.empty(n, dtype=np.float64)
    lib.lto_nearest_distances(_dp(path_xy[0]), _dp(path_xy[1]), n,
                              _dp(boundary_xy[0]), _dp(boundary_xy[1]), m, _dp(out))
    return out


def filter_corners_shifted(mask: np.ndarray, dists: np.ndarray, length: float,
                           proximity: float) -> np.ndarray:
    """The corner-mask morphology on an already roll-shifted mask: straights
    shorter than `proximity` become corner, then corners shorter than
    `length` are dropped."""
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    dists = np.ascontiguousarray(dists, dtype=np.float64)
    lib = _load()
    if lib is None:
        from lap_time_optimization_tpu_torch.utils import corners

        out = corners._merge_short_straights(mask.astype(bool), dists, proximity)
        return corners._drop_short_corners(out, dists, length)
    out = mask.copy()
    lib.lto_filter_corners(out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _dp(dists),
                           len(out), float(length), float(proximity))
    return out.astype(bool)
