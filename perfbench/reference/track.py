"""The NMPC's track tables, worked out again from the raw racing-line files.

A plain NumPy copy of how the measured program builds its tables
(`mpc/track.py::build`): a periodic, chord-length parameterised C² cubic
spline through each of the path, the left and the right boundary points,
resampled at `n` points uniform in arc length (trapezoidal arc-length table
of 4n points, inverted by linear interpolation); the path's signed
curvature; each path sample's distance to the nearest sample of either
boundary; and the velocities artifact, sampled once a metre along the line,
interpolated onto the arc grid.  Everything is float64.
"""

from __future__ import annotations

import json
import os

import numpy as np


def load_points(path: str) -> np.ndarray:
    with open(path) as fh:
        data = json.load(fh)
    return np.asarray([data["path"]["x"], data["path"]["y"]], dtype=np.float64)


def load_velocities(path: str) -> np.ndarray:
    with open(path) as fh:
        return np.asarray(json.load(fh)["velocities"], dtype=np.float64)


def interp(x, xp, fp):
    """Linear interpolation, constant past both ends (np.interp's rule)."""
    return np.interp(x, xp, fp)


class PeriodicSpline:
    """Interpolating periodic cubic spline through points (2, m+1) whose last
    point repeats the first, with knots at the cumulative chord lengths."""

    def __init__(self, points: np.ndarray):
        if not np.allclose(points[:, 0], points[:, -1]):
            points = np.concatenate([points, points[:, :1]], axis=1)
        seg = np.sqrt(np.sum(np.diff(points, axis=1) ** 2, axis=0))
        self.t = np.concatenate([[0.0], np.cumsum(seg)])
        self.length = self.t[-1]
        h = np.diff(self.t)
        p = points[:, :-1]
        m = h.shape[0]
        idx = np.arange(m)
        im1, ip1 = (idx - 1) % m, (idx + 1) % m
        rhs = (p[:, ip1] - p) / h - (p - p[:, im1]) / h[im1]
        A = np.zeros((m, m))
        A[idx, im1] += h[im1] / 6.0
        A[idx, idx] += (h[im1] + h) / 3.0
        A[idx, ip1] += h / 6.0
        M = np.linalg.solve(A, rhs.T).T
        self.h, self.p, self.p1, self.M, self.M1 = h, p, p[:, ip1], M, M[:, ip1]

    def derivative(self, u: np.ndarray, der: int) -> np.ndarray:
        """d^der S / du^der at u (der 1 or 2), (2, len(u))."""
        u = np.mod(u, self.length)
        j = np.clip(np.searchsorted(self.t, u, side="right") - 1, 0, self.h.shape[0] - 1)
        h, ta, tb = self.h[j], self.t[j + 1] - u, u - self.t[j]
        M, M1, p, p1 = self.M[:, j], self.M1[:, j], self.p[:, j], self.p1[:, j]
        if der == 0:
            return (M * ta**3 / (6 * h) + M1 * tb**3 / (6 * h)
                    + (p / h - M * h / 6) * ta + (p1 / h - M1 * h / 6) * tb)
        if der == 1:
            return (-M * ta**2 / (2 * h) + M1 * tb**2 / (2 * h)
                    - (p / h - M * h / 6) + (p1 / h - M1 * h / 6))
        return M * ta / h + M1 * tb / h

    def resample(self, n: int):
        """(xy (2, n), signed curvature (n,), arc length) at n points uniform
        in arc length from the spline's start."""
        u_dense = np.linspace(0.0, self.length, 4 * n)
        d1 = self.derivative(u_dense, 1)
        speed = np.sqrt(d1[0] ** 2 + d1[1] ** 2)
        arc = np.concatenate([[0.0], np.cumsum(0.5 * (speed[1:] + speed[:-1]) * np.diff(u_dense))])
        s_max = arc[-1]
        u = interp(np.linspace(0.0, s_max, n), arc, u_dense)
        xy = self.derivative(u, 0)
        x1, y1 = self.derivative(u, 1)
        x2, y2 = self.derivative(u, 2)
        k = (x1 * y2 - y1 * x2) / (x1**2 + y1**2) ** 1.5
        return xy, k, s_max


def nearest(path_xy: np.ndarray, boundary_xy: np.ndarray) -> np.ndarray:
    dx = path_xy[0][:, None] - boundary_xy[0][None, :]
    dy = path_xy[1][:, None] - boundary_xy[1][None, :]
    return np.sqrt(np.min(dx * dx + dy * dy, axis=1))


class Tables:
    """k, nl, nr, vref (each (n,)) on a uniform arc grid over [0, s_max]."""

    def __init__(self, k, nl, nr, vref, s_max):
        self.k, self.nl, self.nr, self.vref, self.s_max = k, nl, nr, vref, float(s_max)

    @classmethod
    def from_artifacts(cls, directory: str, n: int | None = None) -> "Tables":
        """The tables of an artifact directory (path/left/right/velocities
        JSON files), with n samples (default: one per velocity sample)."""
        vel = load_velocities(os.path.join(directory, "velocities.json"))
        n = len(vel) if n is None else n
        path_xy, k, s_max = PeriodicSpline(load_points(os.path.join(directory, "path.json"))).resample(n)
        left_xy = PeriodicSpline(load_points(os.path.join(directory, "left.json"))).resample(n)[0]
        right_xy = PeriodicSpline(load_points(os.path.join(directory, "right.json"))).resample(n)[0]
        vref = interp(np.linspace(0.0, s_max, n), np.linspace(0.0, s_max, len(vel), endpoint=False), vel)
        return cls(k, nearest(path_xy, left_xy), nearest(path_xy, right_xy), vref, s_max)
