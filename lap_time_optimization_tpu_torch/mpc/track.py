"""NMPC track: racing-line artifacts → lookup tables on a uniform arc grid.

Port of `lap_time_optimization_tpu/mpc/track.py` (reference
src/mpc/track.py, which builds CasADi `interpolant` tables for curvature
k(s), boundary distances NL(s)/NR(s) and reference velocity vref(s)).  The
tables are built in float64 on the host, held as buffers of an `nn.Module`,
and cast and moved to the device once with `.to(device, dtype)`.

Lookups are piecewise linear on the uniform grid by direct index arithmetic,
and closed laps wrap s modulo the lap length.  The lookup gathers with
`index_select`, which `torch.func.vmap(jacfwd(...))` can batch (plain
integer indexing inside those transforms cannot), and takes the cell index
from `floor` with no tangent, as the JAX package does.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch
from torch import nn

from lap_time_optimization_tpu_torch.ops import spline
from lap_time_optimization_tpu_torch.utils import io, native

LOOKUP_FIELDS = ("k_vals", "nl_vals", "nr_vals", "vref_vals", "s_max")
GEOMETRY_FIELDS = ("s_grid", "path_xy", "path_tangent", "left_xy", "right_xy")


class MPCTrack(nn.Module):
    """Lookup tables over a uniform arc-length grid, plus plot geometry.

    Lookup buffers: k_vals (n,) signed curvature of the path, nl_vals /
    nr_vals (n,) distances to the left/right boundary, vref_vals (n,)
    reference velocity, s_max () lap length.  Replay geometry, optional
    (None where only the lookups are needed): s_grid (n,), path_xy /
    path_tangent / left_xy / right_xy (2, n)."""

    def __init__(self, *, closed: bool = True, **tables):
        super().__init__()
        for name in LOOKUP_FIELDS:
            self.register_buffer(name, torch.as_tensor(tables[name]))
        for name in GEOMETRY_FIELDS:
            v = tables.get(name)
            self.register_buffer(name, None if v is None else torch.as_tensor(v))
        self.closed = closed

    def _wrap(self, s):
        return torch.remainder(s, self.s_max) if self.closed else s

    def _cell(self, s, vals):
        """Cell of the UNIFORM arc grid holding s: (lo, hi, unclipped frac,
        inv_ds).  The cell index is clipped to [0, n-2] as an integer, so the
        lookup stays exact and in bounds at both table edges in any dtype."""
        n = vals.shape[0]
        inv_ds = (n - 1) / self.s_max
        t = self._wrap(s) * inv_ds
        i = torch.clamp(torch.floor(t).long(), 0, n - 2)
        idx = i.reshape(-1)
        lo = vals.index_select(0, idx).reshape(i.shape)
        hi = vals.index_select(0, idx + 1).reshape(i.shape)
        return lo, hi, t - i.to(t.dtype), inv_ds

    def _uinterp(self, s, vals):
        """Piecewise-linear lookup, frac clipped to [0, 1]."""
        lo, hi, frac, _ = self._cell(s, vals)
        frac = torch.clamp(frac, 0.0, 1.0)
        return lo * (1.0 - frac) + hi * frac

    def _uinterp_d(self, s, vals):
        """(value, d value / ds).  The slope follows the JAX package's
        derivative of `clip(frac, 0, 1)`: full inside the cell, one half
        where frac sits exactly on a clip bound (a grid point), zero beyond."""
        lo, hi, frac, inv_ds = self._cell(s, vals)
        inside = ((frac > 0.0) & (frac < 1.0)).to(frac.dtype)
        on_bound = ((frac == 0.0) | (frac == 1.0)).to(frac.dtype)
        gain = inside + 0.5 * on_bound
        frac = torch.clamp(frac, 0.0, 1.0)
        return lo * (1.0 - frac) + hi * frac, (hi - lo) * inv_ds * gain

    def curvature(self, s):
        """k(s) (reference src/mpc/track.py:26-37, src/mpc/model.py:66-67)."""
        return self._uinterp(s, self.k_vals)

    def dist_left(self, s):
        return self._uinterp(s, self.nl_vals)

    def dist_right(self, s):
        return self._uinterp(s, self.nr_vals)

    def v_ref(self, s):
        """vref(s) (reference `velocities_interp`, src/mpc/track.py:39-42)."""
        return self._uinterp(s, self.vref_vals)

    def position(self, s):
        """Cartesian point (2, ...) and unit tangent (2, ...) of the path at
        arc length s, by linear interpolation on `s_grid` (replay geometry)."""
        sw = self._wrap(s)
        interp = lambda row: spline.interp(sw, self.s_grid, row)
        return (torch.stack([interp(self.path_xy[0]), interp(self.path_xy[1])]),
                torch.stack([interp(self.path_tangent[0]), interp(self.path_tangent[1])]))


def _resample_closed(points: np.ndarray, n_samples: int):
    """Fit a closed spline through `points` (2, m) and return arc-uniform
    samples: (s_grid, xy, tangent, signed curvature, s_max)."""
    pts = torch.as_tensor(points, dtype=torch.float64)
    if not np.allclose(points[:, 0], points[:, -1]):
        pts = torch.cat([pts, pts[:, :1]], dim=1)
    sp = spline.fit(pts, closed=True)
    # dense arc-length table, then invert onto a uniform arc grid
    u_dense, arc_dense = spline.arc_length_table(sp, n_samples=4 * n_samples)
    s_max = float(arc_dense[-1])
    s_grid = torch.linspace(0.0, s_max, n_samples, dtype=torch.float64)
    u_grid = spline.u_of_arc_length(u_dense, arc_dense, s_grid)
    xy = spline.evaluate(sp, u_grid)
    d1 = spline.evaluate(sp, u_grid, der=1)
    tangent = d1 / torch.linalg.norm(d1, dim=0, keepdim=True)
    k = spline.curvature(sp, u_grid, signed=True)
    return s_grid, xy, tangent, k, s_max


def load(vehicle_name: str, track_name: str, method: str,
         base_dir: str | None = None, n_samples: int | None = None) -> MPCTrack:
    """Load the artifact set for (vehicle, track, method) and build tables,
    with n_samples defaulting to the velocities artifact length."""
    if base_dir is None:
        base_dir = io.default_data_dir()
    d = io.artifact_dir(base_dir, vehicle_name, track_name, method)
    px, py = io.load_artifact(os.path.join(d, "path.json"))
    lx, ly = io.load_artifact(os.path.join(d, "left.json"))
    rx, ry = io.load_artifact(os.path.join(d, "right.json"))
    velocities = io.load_artifact(os.path.join(d, "velocities.json"))
    if n_samples is None:
        n_samples = len(velocities)
    return build(
        np.stack([px, py]), np.stack([lx, ly]), np.stack([rx, ry]), velocities, n_samples
    )


def with_brake_preview(track: MPCTrack, a_brake: float, vref_scale: float = 1.0) -> MPCTrack:
    """Copy of `track` whose vref table is the braking-curve envelope

        w̃(s) = min_{d ≥ 0} sqrt(w(s+d)² + 2·a_brake·d),   w = vref_scale·vref

    so a short horizon sees corner-entry braking points early (see the JAX
    package's docstring for the derivation).  `a_brake = inf` (or ≤ 0)
    returns the track unchanged."""
    if not np.isfinite(a_brake) or a_brake <= 0.0:
        return track
    if not np.isfinite(vref_scale) or vref_scale <= 0.0:
        raise ValueError(
            f"vref_scale must be positive (got {vref_scale}): the envelope is "
            f"computed on the TRACKED target vref_scale*vref"
        )
    v = track.vref_vals.detach().cpu().numpy().astype(np.float64)
    n = v.shape[0]
    ds = float(track.s_max) / (n - 1)
    # envelope on the scaled target == envelope on vref with a/scale²
    a_eff = a_brake / (vref_scale * vref_scale)
    w2 = v * v
    # backward passes to a fixed point: each sweep carries braking
    # information one lap upstream (monotone decreasing, so it terminates)
    while True:
        changed = False
        for i in range(n - 2, -1, -1):
            cap = w2[i + 1] + 2.0 * a_eff * ds
            if cap < w2[i]:
                w2[i] = cap
                changed = True
        if track.closed and w2[0] < w2[-1]:
            # stitch the lap seam: sample 0 and n-1 are the same point
            w2[-1] = w2[0]
            changed = True
        if not changed or not track.closed:
            break
    out = copy.deepcopy(track)
    out.vref_vals = torch.as_tensor(np.sqrt(w2), dtype=track.vref_vals.dtype,
                                    device=track.vref_vals.device)
    return out


def build(path_pts, left_pts, right_pts, velocities, n_samples: int) -> MPCTrack:
    """Construct the float64 lookup tables from raw point sets."""
    s_grid, path_xy, tangent, k, s_max = _resample_closed(np.asarray(path_pts), n_samples)
    _, left_xy, _, _, _ = _resample_closed(np.asarray(left_pts), n_samples)
    _, right_xy, _, _, _ = _resample_closed(np.asarray(right_pts), n_samples)

    path_np = path_xy.numpy()
    nl = torch.as_tensor(native.nearest_distances(path_np, left_xy.numpy()))
    nr = torch.as_tensor(native.nearest_distances(path_np, right_xy.numpy()))

    # vref(s): the velocities artifact is sampled per metre along the racing
    # line (ns-1 entries over [0, s_max)); resample onto the arc grid
    velocities = np.asarray(velocities, dtype=np.float64)
    s_vel = torch.as_tensor(np.linspace(0.0, s_max, len(velocities), endpoint=False))
    vref = spline.interp(s_grid, s_vel, torch.as_tensor(velocities))

    return MPCTrack(
        s_grid=s_grid, k_vals=k, nl_vals=nl, nr_vals=nr, vref_vals=vref,
        s_max=torch.tensor(s_max, dtype=torch.float64),
        path_xy=path_xy, path_tangent=tangent, left_xy=left_xy, right_xy=right_xy,
        closed=True,
    )
