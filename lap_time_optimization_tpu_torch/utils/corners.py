"""Corner detection: threshold + morphological cleanup, numpy on the host —
port of `lap_time_optimization_tpu/utils/corners.py` (reference
src/utils.py:25-105).

1. mark samples whose |curvature| exceeds k_min,
2. roll the mask so that it does not start in the middle of a run,
3. turn straights shorter than `proximity` into corner samples,
4. drop corners shorter than `length`,
5. extract [start, end) sample-index pairs and map them to control points.

The number of corners depends on the data, so this stays on the host; it
runs once per optimisation, outside the iterated objective.
"""

from __future__ import annotations

import numpy as np


def idx_modulo(a: int, b: int, n: int) -> np.ndarray:
    """Indices from a to b wrapping at n (reference src/utils.py:5-14)."""
    i, j = a % n, b % n
    if i < j:
        return np.arange(i, j, dtype=int)
    return np.concatenate([np.arange(i, n, dtype=int), np.arange(0, j, dtype=int)])


def _merge_short_straights(is_corner: np.ndarray, dists: np.ndarray, proximity: float) -> np.ndarray:
    out = is_corner.copy()
    start = 0
    for i in range(1, out.size):
        if out[i - 1] and not out[i]:
            start = i  # corner → straight
        elif not out[i - 1] and out[i]:
            # straight → corner: convert the straight if it was too short
            out[start:i] = (dists[i] - dists[start]) < proximity
    return out


def _drop_short_corners(is_corner: np.ndarray, dists: np.ndarray, length: float) -> np.ndarray:
    out = is_corner.copy()
    start = 0
    for i in range(1, out.size):
        if out[i - 1] and not out[i]:
            # corner → straight: keep the corner only if long enough
            out[start:i] = (dists[i] - dists[start]) > length
        elif not out[i - 1] and out[i]:
            start = i  # straight → corner
    return out


def filter_corners(is_corner: np.ndarray, dists: np.ndarray, length: float, proximity: float) -> np.ndarray:
    """Morphological cleanup with the roll-shift trick (src/utils.py:41-67);
    the sequential passes run in `utils/native.py`."""
    from lap_time_optimization_tpu_torch.utils import native

    is_corner = np.asarray(is_corner, dtype=bool)
    if is_corner.all() or (~is_corner).all():
        return is_corner
    shift = int(np.argmax(is_corner != is_corner[0]))
    rolled = np.roll(is_corner, -shift)
    rolled = native.filter_corners_shifted(rolled, np.asarray(dists, dtype=np.float64), length, proximity)
    return np.roll(rolled, shift)


def corner_idxs(is_corner: np.ndarray) -> np.ndarray:
    """[start, end) sample-index pairs of corner runs (src/utils.py:70-92)."""
    is_corner = np.asarray(is_corner, dtype=bool)
    n = is_corner.size
    if is_corner.all() or (~is_corner).all():
        return np.zeros((0, 2), dtype=int)
    shift = int(np.argmax(is_corner != is_corner[0]))
    rolled = np.roll(is_corner, -shift)
    pairs = []
    start = shift
    for j in range(1, n + 1):
        i = j % n
        if rolled[i - 1] and not rolled[i]:
            pairs.append([start, (i + shift) % n])
        elif not rolled[i - 1] and rolled[i]:
            start = (i + shift) % n
    return np.asarray(pairs, dtype=int).reshape(-1, 2)


def samples_to_controls(s_dist: np.ndarray, s_idx: np.ndarray, c_dist: np.ndarray) -> np.ndarray:
    """Map sample indices to the first control point at or past each sample
    distance (src/utils.py:95-105)."""
    flat = np.asarray(s_idx).ravel()
    c = np.searchsorted(np.asarray(c_dist), np.asarray(s_dist)[flat], side="left")
    return c.reshape(np.shape(s_idx))


def detect_corners(k_abs: np.ndarray, s: np.ndarray, control_dists: np.ndarray,
                   k_min: float, proximity: float, length: float):
    """|κ| sampled at `s` and the control points' chord distances →
    (control-index corner pairs (nc, 2), sample mask), as `define_corners`
    (src/utils.py:25-38)."""
    is_corner = np.asarray(k_abs) > k_min
    is_corner = filter_corners(is_corner, np.asarray(s), length, proximity)
    pairs = corner_idxs(is_corner)
    corners = samples_to_controls(s, pairs, control_dists)
    return corners, is_corner
