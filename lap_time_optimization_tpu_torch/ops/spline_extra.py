"""Alternative spline bases: trigonometric and tension (hyperbolic) splines —
port of `lap_time_optimization_tpu/ops/spline_extra.py`.

The reference's spline-basis comparison (`src/simplify.py`, enum
POLY/TRIG/HYP at src/simplify.py:12-16) was never finished; the JAX package
finishes it and this module ports it:

* **TrigSpline2D** — trigonometric (Fourier) interpolation through the
  control points at parameter nodes uniform in index, scaled to the chord
  length: a DFT (closed curves) or a cosine series of the mirror extension
  (open curves).  The fit and every evaluation are dense products with the
  basis matrix (`torch.matmul`), and every derivative is analytic.
* **TensionSpline2D** — the spline under tension: on each interval
  x'''' − τ²x'' = 0 (basis {1, t, sinh τt, cosh τt}).  τ→0 gives the C²
  cubic spline of `ops/spline`, large τ tightens toward the control
  polygon.  The fit is the moment system with tension weights (cyclic for
  closed tracks, natural ends for open), solved densely.

Both take unbatched points (2, n) like the JAX package and are
differentiable by autograd.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from lap_time_optimization_tpu_torch.ops.spline import chord_lengths


# ============================================================== trigonometric
@dataclasses.dataclass(frozen=True)
class TrigSpline2D:
    """Trigonometric interpolant x(u) = Σ_c coeffs[:, c]·φ_c(u).

    Closed: column 0 is the constant, columns (2k−1, 2k) are cos(kωu),
    sin(kωu) with ω = 2π/T (for an even basis count the last column is the
    Nyquist cosine alone).  Open: the cosine basis φ_c = cos(cπu/T), the
    even (mirror) extension of the data."""

    coeffs: torch.Tensor  # (2, n_basis)
    omega: torch.Tensor  # fundamental angular frequency
    nodes: torch.Tensor  # (n_pts,) parameter values of the control points
    controls: torch.Tensor  # (2, n_pts) control points
    length: torch.Tensor  # chord-length parameter span T
    closed: bool = False


def _trig_col_freqs(n_basis: int, closed: bool, device=None):
    """Per-column harmonic index k and cos/sin selector."""
    cols = torch.arange(n_basis, device=device)
    if closed:
        return (cols + 1) // 2, (cols % 2) == 1
    return cols, torch.ones((n_basis,), dtype=torch.bool, device=device)


def _trig_basis(u: torch.Tensor, omega, n_basis: int, der: int, closed: bool) -> torch.Tensor:
    """φ_c^{(der)}(u) for every column c: (*u.shape, n_basis)."""
    k, is_cos = _trig_col_freqs(n_basis, closed, u.device)
    w = k.to(u.dtype) * omega
    phase = w * u[..., None] + der * (math.pi / 2.0)
    # d/du cos(wu) = w·cos(wu + π/2); d/du sin(wu) = w·sin(wu + π/2)
    vals = torch.where(is_cos, torch.cos(phase), torch.sin(phase)) * w ** der
    const = torch.ones_like(u) if der == 0 else torch.zeros_like(u)
    return torch.cat([const[..., None], vals[..., 1:]], dim=-1)


def trig_fit(points: torch.Tensor, closed: bool) -> TrigSpline2D:
    """Interpolating trigonometric fit through `points` (2, n_pts).

    Nodes are uniform in control-point index, scaled to the chord length T
    (closed: node j = jT/n, the duplicated final point at T; open: node
    j = jT/(n−1)).  On the uniform grid the basis is orthogonal, so the
    fit is a DFT quadrature: one (2×m)@(m×n) product, no linear solve."""
    points = torch.as_tensor(points)
    t = chord_lengths(points)
    T = t[-1]
    ar = lambda n: torch.arange(n, dtype=points.dtype, device=points.device)
    if closed:
        n = points.shape[1] - 1
        q = points[:, :n]
        nodes = T * ar(points.shape[1]) / n
        omega = 2.0 * math.pi / T
        q_nodes = nodes[:n]
    else:
        # even (mirror) extension -> cosine series over period 2T
        n = points.shape[1]
        q = torch.cat([points, torch.flip(points[:, 1:-1], dims=(1,))], dim=1)  # (2, 2(n-1))
        nodes = T * ar(n) / (n - 1)
        omega = math.pi / T
        q_nodes = 2.0 * T * ar(q.shape[1]) / q.shape[1]
    m = q.shape[1]
    # a_k = (2/m) Σ_j q_j cos(kω u_j), b_k = (2/m) Σ_j q_j sin(kω u_j); the
    # constant and (for even counts) Nyquist columns are not doubled
    k_cols, _ = _trig_col_freqs(n, closed, points.device)
    phi = _trig_basis(q_nodes, omega, n, 0, closed)  # (m, n)
    scale = torch.where((k_cols > 0) & (2 * k_cols != m), 2.0, 1.0).to(points.dtype)
    coeffs = (q @ phi) * (scale / m)
    return TrigSpline2D(coeffs=coeffs, omega=omega, nodes=nodes, controls=points, length=T,
                        closed=closed)


def trig_evaluate(sp: TrigSpline2D, u, der: int = 0) -> torch.Tensor:
    """The interpolant (or its analytic derivative) at `u`: (2, *u.shape)."""
    u = torch.as_tensor(u, dtype=sp.coeffs.dtype, device=sp.coeffs.device)
    phi = _trig_basis(u, sp.omega, sp.coeffs.shape[1], der, sp.closed)
    return torch.einsum("cb,...b->c...", sp.coeffs, phi)


# ==================================================================== tension
@dataclasses.dataclass(frozen=True)
class TensionSpline2D:
    """Spline under tension, stored per interval like `Spline2D`."""

    tk: torch.Tensor  # (m+1,) interval edges
    pj: torch.Tensor  # (2, m) left endpoints
    pj1: torch.Tensor  # (2, m) right endpoints
    zj: torch.Tensor  # (2, m) second derivative at the left endpoint
    zj1: torch.Tensor  # (2, m) second derivative at the right endpoint
    h: torch.Tensor  # (m,) interval widths
    tau: torch.Tensor  # tension (per unit parameter)
    controls: torch.Tensor
    length: torch.Tensor
    closed: bool = False


def _tension_weights(tau, h):
    """Off-diagonal a and diagonal share b of the tension moment system;
    a→h/6 and b→h/3 as τ→0 (the cubic limit)."""
    th = tau * h
    a = 1.0 / (tau ** 2 * h) - 1.0 / (tau * torch.sinh(th))
    b = torch.cosh(th) / (tau * torch.sinh(th)) - 1.0 / (tau ** 2 * h)
    return a, b


def tension_fit(points: torch.Tensor, closed: bool, tension: float = 0.5) -> TensionSpline2D:
    """Interpolating C² tension spline; `tension` is τ per unit of
    chord-length parameter (τ→0 recovers `ops.spline.fit`)."""
    points = torch.as_tensor(points)
    t = chord_lengths(points)
    tau = torch.as_tensor(tension, dtype=points.dtype, device=points.device)
    if closed:
        n = points.shape[1] - 1
        p = points[:, :n]
        h = torch.diff(t)
        a, b = _tension_weights(tau, h)
        idx = torch.arange(n, device=points.device)
        im1, ip1 = (idx - 1) % n, (idx + 1) % n
        rhs = (p[:, ip1] - p) / h - (p - p[:, im1]) / h[im1]
        A = torch.zeros((n, n), dtype=h.dtype, device=h.device)
        A = A.index_put((idx, im1), a[im1], accumulate=True)
        A = A.index_put((idx, idx), b[im1] + b, accumulate=True)
        A = A.index_put((idx, ip1), a, accumulate=True)
        z = torch.linalg.solve(A, rhs.T).T
        return TensionSpline2D(tk=t, pj=p, pj1=p[:, ip1], zj=z, zj1=z[:, ip1], h=h, tau=tau,
                               controls=points, length=t[-1], closed=True)
    n = points.shape[1]
    h = torch.diff(t)
    a, b = _tension_weights(tau, h)
    i = torch.arange(1, n - 1, device=points.device)
    rhs = torch.zeros((2, n), dtype=points.dtype, device=points.device)
    rhs[:, i] = (points[:, i + 1] - points[:, i]) / h[i] - (points[:, i] - points[:, i - 1]) / h[i - 1]
    A = torch.zeros((n, n), dtype=h.dtype, device=h.device)
    A = A.index_put((i, i - 1), a[i - 1], accumulate=True)
    A = A.index_put((i, i), b[i - 1] + b[i], accumulate=True)
    A = A.index_put((i, i + 1), a[i], accumulate=True)
    # natural ends: z_0 = z_{n-1} = 0
    A[0, 0] = 1.0
    A[n - 1, n - 1] = 1.0
    z = torch.linalg.solve(A, rhs.T).T
    return TensionSpline2D(tk=t, pj=points[:, :-1], pj1=points[:, 1:], zj=z[:, :-1], zj1=z[:, 1:],
                           h=h, tau=tau, controls=points, length=t[-1], closed=False)


def tension_evaluate(sp: TensionSpline2D, u, der: int = 0) -> torch.Tensor:
    """The tension spline (or its derivative, der ≤ 2) at `u`: (2, *u.shape).

    Segment form: x(t) = [z_j sinh(τ·ta) + z_{j+1} sinh(τ·tb)]/(τ² sinh τh)
    + (p_j − z_j/τ²)·ta/h + (p_{j+1} − z_{j+1}/τ²)·tb/h, with ta the
    distance to the right knot and tb the distance from the left knot."""
    u = torch.as_tensor(u, dtype=sp.tk.dtype, device=sp.tk.device)
    if sp.closed:
        u = torch.remainder(u, sp.length)
    m = sp.h.shape[0]
    j = torch.clamp(torch.searchsorted(sp.tk, u.reshape(-1).contiguous(), right=True).reshape(u.shape) - 1,
                    0, m - 1)
    ta = sp.tk[j + 1] - u
    tb = u - sp.tk[j]
    h = sp.h[j]
    tau = sp.tau
    zj, zj1 = sp.zj[:, j], sp.zj1[:, j]
    pj, pj1 = sp.pj[:, j], sp.pj1[:, j]
    sinh_th = torch.sinh(tau * h)
    inv_h = 1.0 / h
    if der == 0:
        return ((zj * torch.sinh(tau * ta) + zj1 * torch.sinh(tau * tb)) / (tau ** 2 * sinh_th)
                + (pj - zj / tau ** 2) * ta * inv_h
                + (pj1 - zj1 / tau ** 2) * tb * inv_h)
    if der == 1:
        return ((-zj * torch.cosh(tau * ta) + zj1 * torch.cosh(tau * tb)) / (tau * sinh_th)
                - (pj - zj / tau ** 2) * inv_h
                + (pj1 - zj1 / tau ** 2) * inv_h)
    if der == 2:
        return (zj * torch.sinh(tau * ta) + zj1 * torch.sinh(tau * tb)) / sinh_th
    raise ValueError(f"der must be in 0..2, got {der}")


# ============================================================ shared geometry
def _evaluator(sp):
    return trig_evaluate if isinstance(sp, TrigSpline2D) else tension_evaluate


def planar_curvature(d1: torch.Tensor, d2: torch.Tensor, signed: bool = False) -> torch.Tensor:
    """κ from the first and second parameter derivatives (2, ...), the
    formula of reference src/path.py:56-61."""
    k = (d1[0] * d2[1] - d1[1] * d2[0]) / (d1[0] ** 2 + d1[1] ** 2) ** 1.5
    return k if signed else torch.abs(k)


def curvature(sp, u, signed: bool = False) -> torch.Tensor:
    """Curvature of a `TrigSpline2D` or `TensionSpline2D`."""
    ev = _evaluator(sp)
    return planar_curvature(ev(sp, u, der=1), ev(sp, u, der=2), signed)


def gamma2(sp, u) -> torch.Tensor:
    """Curvature energy Σκ² (the racing-line smoothness objective)."""
    k = curvature(sp, u, signed=True)
    return torch.sum(k * k)


def arc_length(sp, u) -> torch.Tensor:
    """Trapezoid arc length over the sample grid `u`."""
    u = torch.as_tensor(u)
    d1 = _evaluator(sp)(sp, u, der=1)
    speed = torch.sqrt(d1[0] ** 2 + d1[1] ** 2)
    return torch.sum(0.5 * (speed[1:] + speed[:-1]) * torch.diff(u))
