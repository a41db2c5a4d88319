"""Checkpoint/resume as npz files — port of `lap_time_optimization_tpu/utils/checkpoint.py`.

Long runs save their full state as named numpy arrays so an interrupted run
resumes exactly.  The NMPC closed loop saves the warm-start inputs and
multipliers, the plant state and the per-step outputs at every chunk
boundary (`mpc/runner.closed_loop_chunked`, tests/test_torch_chunked.py).
"""

from __future__ import annotations

import os

import numpy as np


def save(path: str, **arrays) -> str:
    """Atomic npz write of named arrays (scalars fine)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{k: np.asarray(v) for k, v in arrays.items()})
    os.replace(tmp, path)
    return path


def load(path: str) -> dict:
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def exists(path: str) -> bool:
    return os.path.isfile(path)
