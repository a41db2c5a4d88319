"""Closed-curve cubic splines: the subset `mpc/track.build` needs.

Port of `lap_time_optimization_tpu/ops/spline.py` for closed curves only:
chord-length parameterisation, the dense cyclic moment solve, evaluation of
the curve and its first two derivatives, signed curvature, and the
arc-length table with its inverse.  Track tables are built once on the host,
so this module runs in float64 on the CPU and its outputs are cast and moved
to the device afterwards.  The open not-a-knot fit, the tridiagonal solver
and `gamma2` come with the racing-line slice.

An interpolating periodic C² cubic spline with knots at the data sites is
unique, so the dense moment solve reproduces FITPACK's `per=1` interpolant
(reference src/path.py:25) up to roundoff.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Spline2D:
    """A fitted closed 2-D cubic spline, stored per interval."""

    tk: torch.Tensor  # (m+1,) interval edges in parameter space
    pj: torch.Tensor  # (2, m) left endpoint of each interval
    pj1: torch.Tensor  # (2, m) right endpoint of each interval
    Mj: torch.Tensor  # (2, m) second derivative (moment) at left endpoint
    Mj1: torch.Tensor  # (2, m) moment at right endpoint
    h: torch.Tensor  # (m,) interval widths
    controls: torch.Tensor  # (2, n_ctrl) control points (incl. duplicate)
    length: torch.Tensor  # scalar, total parameter (chord) length
    closed: bool = True


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation with `jnp.interp`'s semantics: constant
    extrapolation past both ends, and the left sample where an interval is
    narrower than the dtype's smallest step."""
    x = torch.as_tensor(x, dtype=xp.dtype, device=xp.device)
    i = torch.searchsorted(xp, x.reshape(-1).contiguous(), right=True).reshape(x.shape)
    i = torch.clamp(i, 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = torch.tensor(torch.finfo(xp.dtype).eps, dtype=xp.dtype)
    epsilon = float(torch.nextafter(eps, 2 * eps) - eps)  # np.spacing(eps)
    dx0 = torch.abs(dx) <= epsilon
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def chord_lengths(points: torch.Tensor) -> torch.Tensor:
    """Cumulative linear (chord) distance at each point; points is (2, n).
    Mirrors the reference's `cumulative_distances` (src/path.py:11-14)."""
    seg = torch.sqrt(torch.sum(torch.diff(points, dim=1) ** 2, dim=0))
    return torch.cat([torch.zeros((1,), dtype=seg.dtype, device=seg.device), torch.cumsum(seg, 0)])


def _cyclic_moment_system(p: torch.Tensor, h: torch.Tensor):
    """Build the cyclic tridiagonal system A @ M = rhs for a periodic spline.

    p: (2, n) distinct points; h: (n,) interval widths, h[i] = t[i+1]-t[i]
    with period T = sum(h).  Continuity of S' at each knot gives, for every i
    (indices mod n):
      h[i-1]/6 M[i-1] + (h[i-1]+h[i])/3 M[i] + h[i]/6 M[i+1]
        = (p[i+1]-p[i])/h[i] - (p[i]-p[i-1])/h[i-1]
    """
    n = h.shape[0]
    idx = torch.arange(n, device=h.device)
    im1 = (idx - 1) % n
    ip1 = (idx + 1) % n
    h_im1 = h[im1]
    rhs = (p[:, ip1] - p) / h - (p - p[:, im1]) / h_im1  # (2, n)
    A = torch.zeros((n, n), dtype=h.dtype, device=h.device)
    A.index_put_((idx, im1), h_im1 / 6.0, accumulate=True)
    A.index_put_((idx, idx), (h_im1 + h) / 3.0, accumulate=True)
    A.index_put_((idx, ip1), h / 6.0, accumulate=True)
    return A, rhs


def fit(points: torch.Tensor, closed: bool = True) -> Spline2D:
    """Fit an interpolating closed cubic spline through `points` (2, n_pts),
    chord-length parameterised like the reference's `splprep(..., per=1)`
    (src/path.py:20-26).  The last point must duplicate the first: it defines
    the period and is otherwise ignored."""
    if not closed:
        raise NotImplementedError("open splines are not ported yet (racing-line slice)")
    points = torch.as_tensor(points)
    t = chord_lengths(points)
    n = points.shape[1] - 1
    p = points[:, :n]
    h = torch.diff(t)  # (n,)
    A, rhs = _cyclic_moment_system(p, h)
    M = torch.linalg.solve(A, rhs.T).T  # (2, n)
    ip1 = (torch.arange(n, device=points.device) + 1) % n
    return Spline2D(
        tk=t, pj=p, pj1=p[:, ip1], Mj=M, Mj1=M[:, ip1], h=h,
        controls=points, length=t[-1], closed=True,
    )


def _locate(sp: Spline2D, u: torch.Tensor):
    """Map parameter values to (interval index, local coordinates)."""
    if sp.closed:
        u = torch.remainder(u, sp.length)
    m = sp.h.shape[0]
    j = torch.searchsorted(sp.tk, u.reshape(-1).contiguous(), right=True).reshape(u.shape)
    j = torch.clamp(j - 1, 0, m - 1)
    ta = sp.tk[j + 1] - u  # distance to right knot
    tb = u - sp.tk[j]  # distance from left knot
    return j, ta, tb


def evaluate(sp: Spline2D, u: torch.Tensor, der: int = 0) -> torch.Tensor:
    """The spline (or its der-th parameter derivative, der ≤ 2) at `u`.
    Returns (2, *u.shape)."""
    u = torch.as_tensor(u, dtype=sp.tk.dtype, device=sp.tk.device)
    j, ta, tb = _locate(sp, u)
    h = sp.h[j]
    Mj, Mj1 = sp.Mj[:, j], sp.Mj1[:, j]
    pj, pj1 = sp.pj[:, j], sp.pj1[:, j]
    inv_h = 1.0 / h
    if der == 0:
        return (
            Mj * ta**3 * (inv_h / 6.0)
            + Mj1 * tb**3 * (inv_h / 6.0)
            + (pj * inv_h - Mj * h / 6.0) * ta
            + (pj1 * inv_h - Mj1 * h / 6.0) * tb
        )
    if der == 1:
        return (
            -Mj * ta**2 * (inv_h / 2.0)
            + Mj1 * tb**2 * (inv_h / 2.0)
            - (pj * inv_h - Mj * h / 6.0)
            + (pj1 * inv_h - Mj1 * h / 6.0)
        )
    if der == 2:
        return Mj * ta * inv_h + Mj1 * tb * inv_h
    raise ValueError(f"der must be in 0..2, got {der}")


def curvature(sp: Spline2D, u: torch.Tensor, signed: bool = False) -> torch.Tensor:
    """κ = (x' y'' − y' x'') / (x'² + y'²)^{3/2} (reference src/path.py:56-61)."""
    d1 = evaluate(sp, u, der=1)
    d2 = evaluate(sp, u, der=2)
    num = d1[0] * d2[1] - d1[1] * d2[0]
    den = (d1[0] ** 2 + d1[1] ** 2) ** 1.5
    k = num / den
    return k if signed else torch.abs(k)


def arc_length_table(sp: Spline2D, n_samples: int = 1000):
    """Cumulative arc length over a uniform parameter grid by trapezoids of
    ‖dS/du‖ (reference src/path.py:156-172).  Returns (u, arc)."""
    u = torch.linspace(0.0, float(sp.length), n_samples, dtype=sp.tk.dtype, device=sp.tk.device)
    d1 = evaluate(sp, u, der=1)
    speed = torch.sqrt(d1[0] ** 2 + d1[1] ** 2)
    ds = 0.5 * (speed[1:] + speed[:-1]) * torch.diff(u)
    arc = torch.cat([torch.zeros((1,), dtype=ds.dtype, device=ds.device), torch.cumsum(ds, 0)])
    return u, arc


def u_of_arc_length(u_sampled: torch.Tensor, arc_sampled: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Invert the arc-length table: s ↦ u by linear interpolation
    (reference `find_u_given_s`, src/path.py:174-185)."""
    return interp(s, arc_sampled, u_sampled)
