"""Differentiable cubic splines — port of `lap_time_optimization_tpu/ops/spline.py`.

Chord-length parameterisation, the moment (second-derivative) solves, the
evaluation of the curve and its first two derivatives, curvature, the
curvature energy `gamma2`, and the arc-length table with its inverse.

Every function takes an optional leading candidate axis: (B, 2, n) points
give a batched `Spline2D` whose fields carry the batch in front, and
`evaluate`/`curvature` then take parameter values (B, M) and return
(B, 2, M) / (B, M).  Without it, points are (2, n) and `evaluate` returns
(2, *u.shape), as in the JAX package.

Closed curves have two moment solves that agree to roundoff in float64
(tests/test_torch_spline_track.py): a dense `torch.linalg.solve` of the
cyclic system and an O(n) cyclic Thomas + Sherman–Morrison recurrence.  The
two defaults below keep the JAX package's per-regime choice.  Open curves
use the dense not-a-knot system.  The dense solves are `linalg.solve_ex`
without its error check, which on a CUDA device would sync with the host
(and so could not be captured in a CUDA graph); the values are
`linalg.solve`'s.

An interpolating periodic C² cubic spline with knots at the data sites is
unique, so the closed fit reproduces FITPACK's `per=1` interpolant
(reference src/path.py:25) up to roundoff.
"""

from __future__ import annotations

import dataclasses

import torch

#: Moment solve for CLOSED splines on every differentiated path (the
#: direct-laptime minimise, the searches' L-BFGS refinement): "dense".  In
#: float32 the tridiag recurrence accumulates error over its ~n serial steps
#: and the curvature amplifies it into the gradients (the MX5 direct-laptime
#: run converged to 57.21 s with tridiag against 52.06 s with dense in the
#: JAX package, spline.py:181-190 there).
FIT_METHOD_CLOSED = "dense"
#: Moment solve for wide batched FORWARD-ONLY candidate evaluation (the
#: searches' `_batch_lap_times(solver="fused")`): "tridiag", O(n) per
#: candidate; ranking candidates is insensitive to its float32 noise.
FIT_METHOD_CLOSED_BATCHED = "tridiag"


@dataclasses.dataclass(frozen=True)
class Spline2D:
    """A fitted 2-D cubic spline, stored per interval.  Every tensor field
    may carry the same leading batch shape `lead` in front."""

    tk: torch.Tensor  # (*lead, m+1) interval edges in parameter space
    pj: torch.Tensor  # (*lead, 2, m) left endpoint of each interval
    pj1: torch.Tensor  # (*lead, 2, m) right endpoint of each interval
    Mj: torch.Tensor  # (*lead, 2, m) second derivative (moment) at left endpoint
    Mj1: torch.Tensor  # (*lead, 2, m) moment at right endpoint
    h: torch.Tensor  # (*lead, m) interval widths
    controls: torch.Tensor  # (*lead, 2, n_ctrl) control points (incl. duplicate)
    length: torch.Tensor  # (*lead,) total parameter (chord) length
    closed: bool = False

    @property
    def batched(self) -> bool:
        return self.tk.dim() > 1


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
    """Cumulative linear (chord) distance at each point; points is
    (*lead, 2, n).  Mirrors the reference's `cumulative_distances`
    (src/path.py:11-14)."""
    seg = torch.sqrt(torch.sum(torch.diff(points, dim=-1) ** 2, dim=-2))
    zero = torch.zeros(seg.shape[:-1] + (1,), dtype=seg.dtype, device=seg.device)
    return torch.cat([zero, torch.cumsum(seg, -1)], dim=-1)


def _cyclic_rhs(p: torch.Tensor, h: torch.Tensor):
    """(h[i-1], rhs) of the periodic moment system; p (*lead, 2, n), h (*lead, n)."""
    n = h.shape[-1]
    idx = torch.arange(n, device=h.device)
    im1, ip1 = (idx - 1) % n, (idx + 1) % n
    h_im1 = h[..., im1]
    rhs = (p[..., ip1] - p) / h[..., None, :] - (p - p[..., im1]) / h_im1[..., None, :]
    return h_im1, rhs


def _cyclic_moment_system(p: torch.Tensor, h: torch.Tensor):
    """The cyclic tridiagonal system A @ M = rhs of a periodic spline.

    p: (*lead, 2, n) distinct points; h: (*lead, n) interval widths,
    h[i] = t[i+1]-t[i], period T = sum(h).  Continuity of S' at each knot
    gives, for every i (indices mod n):
      h[i-1]/6 M[i-1] + (h[i-1]+h[i])/3 M[i] + h[i]/6 M[i+1]
        = (p[i+1]-p[i])/h[i] - (p[i]-p[i-1])/h[i-1]
    A is a sum of three diagonals placed by one-hot matrices, so entries
    that coincide (n < 3) add, as the JAX package's `.at[].add` does."""
    n = h.shape[-1]
    h_im1, rhs = _cyclic_rhs(p, h)
    idx = torch.arange(n, device=h.device)
    eye = torch.eye(n, dtype=h.dtype, device=h.device)
    A = ((h_im1 / 6.0)[..., :, None] * eye[(idx - 1) % n]
         + ((h_im1 + h) / 3.0)[..., :, None] * eye
         + (h / 6.0)[..., :, None] * eye[(idx + 1) % n])
    return A, rhs


def _notaknot_moment_system(p: torch.Tensor, h: torch.Tensor):
    """Moment system of an open spline with not-a-knot end conditions.

    p: (*lead, 2, n) points; h: (*lead, n-1) interval widths.  Interior rows
    are the C¹-continuity equations; the first/last rows impose third
    derivative continuity across the first/last interior knots."""
    n = p.shape[-1]
    lead = p.shape[:-2]
    i = torch.arange(1, n - 1, device=p.device)
    rhs = torch.zeros(lead + (2, n), dtype=p.dtype, device=p.device)
    rhs[..., i] = ((p[..., i + 1] - p[..., i]) / h[..., None, i]
                   - (p[..., i] - p[..., i - 1]) / h[..., None, i - 1])
    A = torch.zeros(lead + (n, n), dtype=h.dtype, device=h.device)
    A[..., i, i - 1] = h[..., i - 1] / 6.0
    A[..., i, i] = (h[..., i - 1] + h[..., i]) / 3.0
    A[..., i, i + 1] = h[..., i] / 6.0
    # not-a-knot at t[1]:   M0*h1 - M1*(h0+h1) + M2*h0 = 0
    A[..., 0, 0] = h[..., 1]
    A[..., 0, 1] = -(h[..., 0] + h[..., 1])
    A[..., 0, 2] = h[..., 0]
    # not-a-knot at t[n-2]: M[n-3]*h[n-2] - M[n-2]*(h[n-3]+h[n-2]) + M[n-1]*h[n-3] = 0
    A[..., n - 1, n - 3] = h[..., n - 2]
    A[..., n - 1, n - 2] = -(h[..., n - 3] + h[..., n - 2])
    A[..., n - 1, n - 1] = h[..., n - 3]
    return A, rhs


def _thomas(dl: torch.Tensor, dm: torch.Tensor, du: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Pivot-free Thomas solve of tridiag(dl, dm, du) @ x = rhs.

    dl/dm/du: (*lead, n) sub/main/super diagonals (dl[0], du[n-1] ignored);
    rhs: (*lead, n, k).  2n serial steps, each elementwise over the batch.
    No pivoting: valid for the strictly diagonally dominant spline moment
    systems ((h₋+h₊)/3 > h₋/6 + h₊/6 always)."""
    n = dm.shape[-1]
    cp = torch.zeros_like(dm[..., 0])
    dp = torch.zeros_like(rhs[..., 0, :])
    cps, dps = [], []
    for i in range(n):
        a, b, c = dl[..., i], dm[..., i], du[..., i]
        denom = b - a * cp
        cp = c / denom
        dp = (rhs[..., i, :] - a[..., None] * dp) / denom[..., None]
        cps.append(cp)
        dps.append(dp)
    x = torch.zeros_like(dp)
    xs = [None] * n
    for i in reversed(range(n)):
        x = dps[i] - cps[i][..., None] * x
        xs[i] = x
    return torch.stack(xs, dim=-2)


def _cyclic_thomas(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve the cyclic tridiagonal system with wrap entries a[0] (col n-1 of
    row 0) and c[n-1] (col 0 of row n-1) via Sherman–Morrison: write
    A = T + u vᵀ with a pure tridiagonal T, solve T[y q] = [rhs u] in ONE
    Thomas pass, and correct x = y − q (v·y)/(1 + v·q).  rhs (*lead, n, k)."""
    k = rhs.shape[-1]
    gamma = -b[..., :1]
    ratio = a[..., :1] / gamma
    bm = torch.cat([b[..., :1] + (-gamma), b[..., 1:-1], b[..., -1:] + (-c[..., -1:] * a[..., :1] / gamma)], dim=-1)
    zeros = torch.zeros_like(b[..., 1:-1])
    u = torch.cat([gamma, zeros, c[..., -1:]], dim=-1)
    sol = _thomas(a, bm, c, torch.cat([rhs, u[..., None]], dim=-1))
    y, q = sol[..., :k], sol[..., k]
    v_dot_y = y[..., 0, :] + ratio * y[..., -1, :]  # (*lead, k)
    v_dot_q = q[..., :1] + ratio * q[..., -1:]  # (*lead, 1)
    return y - q[..., None] * (v_dot_y / (1.0 + v_dot_q))[..., None, :]


def _cyclic_moments_tridiag(p: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Periodic moment solve in O(n): the system of `_cyclic_moment_system`,
    solved structured.  Returns M of shape (*lead, 2, n)."""
    h_im1, rhs = _cyclic_rhs(p, h)
    return _cyclic_thomas(h_im1 / 6.0, (h_im1 + h) / 3.0, h / 6.0, rhs.transpose(-1, -2)).transpose(-1, -2)


def fit(points: torch.Tensor, closed: bool, method: str | None = None) -> Spline2D:
    """Fit an interpolating cubic spline through `points` (*lead, 2, n_pts),
    chord-length parameterised like the reference's
    `splprep(..., u=cumulative_distances(controls), k=3, s=0, per=closed)`
    (src/path.py:20-26).  For closed curves the last point must duplicate
    the first: it defines the period and is otherwise ignored.  `method`
    selects the closed moment solve ("dense" or "tridiag", default
    `FIT_METHOD_CLOSED`)."""
    points = torch.as_tensor(points)
    method = method or FIT_METHOD_CLOSED
    t = chord_lengths(points)
    h = torch.diff(t, dim=-1)
    if closed:
        n = points.shape[-1] - 1
        p = points[..., :n]
        if method == "tridiag":
            M = _cyclic_moments_tridiag(p, h)
        elif method == "dense":
            A, rhs = _cyclic_moment_system(p, h)
            M = torch.linalg.solve_ex(A, rhs.transpose(-1, -2))[0].transpose(-1, -2)
        else:
            raise ValueError(f"unknown closed-spline method {method!r}")
        ip1 = (torch.arange(n, device=points.device) + 1) % n
        return Spline2D(tk=t, pj=p, pj1=p[..., ip1], Mj=M, Mj1=M[..., ip1], h=h,
                        controls=points, length=t[..., -1], closed=True)
    A, rhs = _notaknot_moment_system(points, h)
    M = torch.linalg.solve_ex(A, rhs.transpose(-1, -2))[0].transpose(-1, -2)
    return Spline2D(tk=t, pj=points[..., :-1], pj1=points[..., 1:], Mj=M[..., :-1],
                    Mj1=M[..., 1:], h=h, controls=points, length=t[..., -1], closed=False)


def knot_adjoint(g: torch.Tensor, j: torch.Tensor, m: int, masked: bool) -> torch.Tensor:
    """Adjoint of gathering (*lead, C, m) interval data at the sample
    intervals j (*lead, M): each interval's sum of the sample adjoints g
    (*lead, C, M) that hit it.  `masked=False`: `scatter_add`, gather's own
    backward.  `masked=True`: one masked reduction over the sample axis,
    which sums in the same order on every run (a NaN or inf adjoint stays at
    its own interval, as with scatter_add)."""
    if not masked:
        idx = j.unsqueeze(-2).expand(g.shape)
        return torch.zeros(g.shape[:-1] + (m,), dtype=g.dtype, device=g.device).scatter_add_(-1, idx, g)
    hit = (j.unsqueeze(-1) == torch.arange(m, device=j.device)).unsqueeze(-3)  # (*lead, 1, M, m)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    return torch.where(hit, g.unsqueeze(-1), zero).sum(-2)


class _KnotGather(torch.autograd.Function):
    """`torch.gather` of per-interval data (*lead, m) or (*lead, C, m) at the
    sample intervals j (*lead, M), with a deterministic backward.

    Many samples share one interval, so gather's own backward is a
    `scatter_add`, whose atomic adds on a CUDA device sum in a different
    order from run to run (the card's seeded searches were not
    reproducible).  On a CUDA device the adjoints of all sources are
    reduced by `knot_adjoint(masked=True)` in one pass; on the CPU, where
    scatter_add is sequential, by scatter_add."""

    @staticmethod
    def forward(ctx, j, *srcs):
        ctx.save_for_backward(j)
        ctx.shapes, ctx.dtype = [s.shape for s in srcs], srcs[0].dtype
        return tuple(torch.gather(s, -1, j if s.dim() == j.dim() else
                                  j.unsqueeze(-2).expand(s.shape[:-1] + j.shape[-1:]))
                     for s in srcs)

    @staticmethod
    def backward(ctx, *grads):
        (j,) = ctx.saved_tensors
        chans = [1 if len(shape) == j.dim() else shape[-2] for shape in ctx.shapes]
        g = torch.cat([torch.zeros(j.shape[:-1] + (c, j.shape[-1]), dtype=ctx.dtype, device=j.device)
                       if gi is None else gi.reshape(j.shape[:-1] + (c, j.shape[-1]))
                       for gi, c in zip(grads, chans)], dim=-2)
        adj = knot_adjoint(g, j, ctx.shapes[0][-1], masked=j.is_cuda).split(chans, dim=-2)
        return (None, *(a.reshape(shape) for a, shape in zip(adj, ctx.shapes)))


def _batched_eval(sp: Spline2D, u: torch.Tensor, der: int) -> torch.Tensor:
    """`evaluate` on a batched spline: u (*lead, M) → (*lead, 2, M)."""
    if sp.closed:
        u = torch.remainder(u, sp.length[..., None])
    m = sp.h.shape[-1]
    j = torch.searchsorted(sp.tk.contiguous(), u.contiguous(), right=True)
    j = torch.clamp(j - 1, 0, m - 1)
    tk_r, tk_l, h, Mj, Mj1, pj, pj1 = _KnotGather.apply(
        j, sp.tk[..., 1:], sp.tk[..., :-1], sp.h, sp.Mj, sp.Mj1, sp.pj, sp.pj1)
    ta = tk_r - u  # distance to right knot
    tb = u - tk_l  # distance from left knot
    ta, tb, h = ta.unsqueeze(-2), tb.unsqueeze(-2), h.unsqueeze(-2)
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
    if der == 3:
        return (Mj1 - Mj) * inv_h
    raise ValueError(f"der must be in 0..3, got {der}")


def evaluate(sp: Spline2D, u: torch.Tensor, der: int = 0) -> torch.Tensor:
    """The spline (or its der-th parameter derivative, der ≤ 3) at `u`.
    Unbatched: u of any shape → (2, *u.shape).  Batched: u (*lead, M) →
    (*lead, 2, M)."""
    u = torch.as_tensor(u, dtype=sp.tk.dtype, device=sp.tk.device)
    if sp.batched:
        return _batched_eval(sp, u, der)
    one = dataclasses.replace(sp, **{f.name: getattr(sp, f.name).unsqueeze(0)
                                     for f in dataclasses.fields(sp) if f.name != "closed"})
    return _batched_eval(one, u.reshape(1, -1), der)[0].reshape((2,) + u.shape)


def curvature(sp: Spline2D, u: torch.Tensor, signed: bool = False) -> torch.Tensor:
    """κ = (x' y'' − y' x'') / (x'² + y'²)^{3/2} (reference src/path.py:56-61),
    of u's shape (batched: (*lead, M))."""
    axis = -2 if sp.batched else 0
    x1, y1 = evaluate(sp, u, der=1).unbind(axis)
    x2, y2 = evaluate(sp, u, der=2).unbind(axis)
    k = (x1 * y2 - y1 * x2) / (x1 ** 2 + y1 ** 2) ** 1.5
    return k if signed else torch.abs(k)


def gamma2(sp: Spline2D, u: torch.Tensor) -> torch.Tensor:
    """Curvature energy Γ² = Σ κ(uᵢ)² over the sample points (reference
    src/path.py:63-77); (*lead,) for a batched spline, else a scalar."""
    k = curvature(sp, u, signed=True)
    return torch.sum(k * k, dim=-1) if sp.batched else torch.sum(k * k)


def uniform_samples(length: torch.Tensor, ns: int) -> torch.Tensor:
    """`jnp.linspace(0, length, ns)` over (*lead,) lengths → (*lead, ns),
    differentiable in the length: the fixed-count sample grid over the
    current path length (reference src/trajectory.py:45)."""
    t = torch.arange(ns - 1, dtype=length.dtype, device=length.device) / (ns - 1)
    return torch.cat([length[..., None] * t, length[..., None]], dim=-1)


def arc_length_table(sp: Spline2D, n_samples: int = 1000):
    """Cumulative arc length over a uniform parameter grid by trapezoids of
    ‖dS/du‖ (reference src/path.py:156-172), for an unbatched spline.
    Returns (u, arc)."""
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
