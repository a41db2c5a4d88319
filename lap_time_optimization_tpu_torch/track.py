"""Track: cone boundaries, usable-width shrink, alpha → control-point maps.

Port of `lap_time_optimization_tpu/track.py` (reference src/track.py).  The
geometry is held as float64 buffers of an `nn.Module`, so
`track.to(device, dtype)` moves and casts it once; loading and shrinking
stay in numpy on the host.

The racing line is parameterised by per-control-point lateral offsets
alpha ∈ [0, 1]: control point i is `left_i + alpha_i * (right_i - left_i)`
(reference src/track.py:82-87).  For closed tracks alpha wraps (the
duplicated last cone reuses alpha_0).  Both alpha maps take a leading batch
axis: alphas (..., size) give control points (..., 2, n).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from lap_time_optimization_tpu_torch.ops import spline
from lap_time_optimization_tpu_torch.utils import io

FIELDS = ("left", "right", "diffs", "widths", "old_left", "old_right", "length")


def is_closed(left: np.ndarray, right: np.ndarray) -> bool:
    """A track is closed iff first == last cone on both sides (src/utils.py:17-22)."""
    return bool(np.all(left[:, 0] == left[:, -1]) and np.all(right[:, 0] == right[:, -1]))


def shrink_boundaries(left: np.ndarray, right: np.ndarray, usable_width: float):
    """Move both boundaries toward the centre line by the unusable fraction:
    `usable_width` ∈ [0.001, 1.0] of the track width stays (reference
    src/track.py:96-118, clamping at src/track.py:17-21)."""
    usable_width = min(1.0, max(0.001, usable_width))
    margin = (1.0 - usable_width) / 2.0
    diff = right - left
    return left + margin * diff, right - margin * diff


class Track(nn.Module):
    """Track geometry as buffers: left/right (2, n_cones) shrunk boundaries,
    diffs = right − left, widths (n_cones,), old_left/old_right (2, n_cones)
    unshrunk boundaries for plots, length () the centre line's chord length.
    `size` counts the *independent* control points (closed tracks drop the
    duplicated last cone) and `ns` the per-metre samples of the lap, both
    fixed at load time (reference src/track.py:24, src/trajectory.py:35)."""

    def __init__(self, *, closed: bool = True, size: int = 0, ns: int = 0, name: str = "",
                 decongest_stride: int = 3, **arrays):
        super().__init__()
        for f in FIELDS:
            self.register_buffer(f, torch.as_tensor(arrays[f]))
        self.closed = closed
        self.size = size
        self.ns = ns
        self.name = name
        self.decongest_stride = decongest_stride

    @classmethod
    def load(cls, name_or_path: str, track_width: float = 1.0) -> "Track":
        """Load a track JSON (by name or path) and apply the width shrink."""
        path = io.resolve_track(name_or_path)
        name, left, right = io.load_track_json(path)
        return cls.from_cones(left, right, track_width=track_width, name=name)

    @classmethod
    def from_cones(cls, left, right, track_width: float | None = None, name: str = "",
                   old_left=None, old_right=None) -> "Track":
        left = np.asarray(left, dtype=np.float64)
        right = np.asarray(right, dtype=np.float64)
        if old_left is None:
            old_left, old_right = left, right
        if track_width is not None:
            left, right = shrink_boundaries(left, right, track_width)
        closed = is_closed(left, right)
        diffs = right - left
        mid = 0.5 * (left + right)
        # centre-line chord length over all cones (incl. the closing segment)
        length = float(np.sum(np.hypot(*np.diff(mid, axis=1))))
        return cls(left=left, right=right, diffs=diffs, widths=np.hypot(diffs[0], diffs[1]),
                   old_left=np.asarray(old_left, dtype=np.float64),
                   old_right=np.asarray(old_right, dtype=np.float64),
                   length=np.asarray(length), closed=closed,
                   size=left.shape[1] - int(closed), ns=math.ceil(length), name=name)

    # ------------------------------------------------------------ alpha maps
    def control_points(self, alphas: torch.Tensor) -> torch.Tensor:
        """alphas (..., size) → spline control points (..., 2, n_cones);
        closed tracks reuse alphas[0] for the duplicated final cone
        (reference src/track.py:82-87)."""
        if self.closed:
            alphas = torch.cat([alphas, alphas[..., :1]], dim=-1)
        return self.left + alphas[..., None, :] * self.diffs

    def mid_spline(self) -> spline.Spline2D:
        """Spline through the centre line (alphas = 0.5)."""
        alphas = torch.full((self.size,), 0.5, dtype=self.left.dtype, device=self.left.device)
        return spline.fit(self.control_points(alphas), self.closed)

    def path_spline(self, alphas: torch.Tensor, method: str | None = None) -> spline.Spline2D:
        """Racing-line spline for alphas (..., size).  `method` selects the
        closed moment solve (`spline.FIT_METHOD_CLOSED*`): batched
        forward-only callers pass `spline.FIT_METHOD_CLOSED_BATCHED`."""
        return spline.fit(self.control_points(alphas), self.closed, method)

    # ------------------------------------------------------ decongested BO
    @property
    def decongested_indices(self) -> np.ndarray:
        """Every 3rd *distinct* control-point index, the reduced search
        parameterisation (reference src/track.py:40-49; the loop is closed
        explicitly by `control_points_decongested`)."""
        return np.arange(0, self.size, self.decongest_stride)

    def control_points_decongested(self, alphas: torch.Tensor) -> torch.Tensor:
        """alphas (..., n_dec) over the decongested subset → control points
        (..., 2, n_dec[+1]), the wrap duplicate reusing alphas[0] on closed
        tracks (reference `control_points_bayesian`, src/track.py:89-94)."""
        idx = torch.as_tensor(self.decongested_indices, device=self.left.device)
        left = self.left[:, idx]
        diffs = self.diffs[:, idx]
        if self.closed:
            alphas = torch.cat([alphas, alphas[..., :1]], dim=-1)
            left = torch.cat([left, left[:, :1]], dim=1)
            diffs = torch.cat([diffs, diffs[:, :1]], dim=1)
        return left + alphas[..., None, :] * diffs

    @property
    def n_decongested(self) -> int:
        return len(self.decongested_indices)


def synthetic_circuit(ns: int, seed: int = 0, lobes: int = 12, width: float = 10.0,
                      spacing: float = 10.0):
    """Cones (left, right), each (2, m + 1) with the last pair repeating the
    first, of a seeded closed circuit whose centre line is ns − 0.5 m long,
    so that `Track.from_cones(left, right)` samples it ns times (`Track.ns`):
    a full-size circuit for any lap length, with no data file.

    The shape is a ring with lobes: centre radius r(θ) = R·(1 + 0.04·sin(lobes·θ
    + φ) + 0.004·Σ sin(k·θ + φₖ)) over three seeded harmonics k in [20, 60),
    R scaled to the length, the cones `width`/2 inside and outside r(θ)
    (left is inside: the lap runs anticlockwise), a pair every ~`spacing` m.
    """
    rng = np.random.default_rng(seed)
    length = ns - 0.5
    m = max(8, round(length / spacing))
    th = np.linspace(0.0, 2.0 * np.pi, m + 1)
    shape = 1.0 + 0.04 * np.sin(lobes * th + rng.uniform(0.0, 2.0 * np.pi))
    for k in rng.integers(20, 60, size=3):
        shape = shape + 0.004 * np.sin(k * th + rng.uniform(0.0, 2.0 * np.pi))
    ring = np.stack([np.cos(th), np.sin(th)])
    r_mid = length / float(np.sum(np.hypot(*np.diff(shape * ring, axis=1)))) * shape
    left, right = (r_mid - 0.5 * width) * ring, (r_mid + 0.5 * width) * ring
    left[:, -1], right[:, -1] = left[:, 0], right[:, 0]
    return left, right
