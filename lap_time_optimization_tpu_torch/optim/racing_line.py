"""Racing-line methods: curvature, compromise, lap time, estimated and
sectors — port of `lap_time_optimization_tpu/optim/racing_line.py`
(reference src/trajectory.py).

alphas → spline fit → curvature → velocity profile → lap time is one
differentiable PyTorch graph, minimised by the zoom L-BFGS of
`ops/optimize.py` on autograd gradients (on the card each value and
gradient is one replay of a CUDA graph).  Where the JAX package vmaps, the
port runs one optimiser over a leading instance axis: every ε of the
compromise grid, and every sector × ε of the sector method, is one
instance with its own iteration count and line search.

`solver` chooses the velocity profile, as in `optim/global_search`:

* "scan" (the default) — the sequential `ops/velocity.solve_profile`
  everywhere, the JAX package's semantics;
* "assoc" — the log-depth `solve_profile_parallel` everywhere;
* "fused" — forward-only lap scoring (the compromise sweep's ε scores, the
  sector sweep's scores and `evaluate`) on kernel 3,
  `ops/velocity_batch.solve_profile_batch` (its plain twin on the CPU), and
  gradients (the lap-time objective) on "assoc": on the card, autograd
  through the sequential profile is tens of thousands of eager launches
  per value and gradient, and the kernel is forward-only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lap_time_optimization_tpu_torch.ops import optimize, spline, velocity, velocity_batch
from lap_time_optimization_tpu_torch.track import Track
from lap_time_optimization_tpu_torch.utils import corners as corner_utils
from lap_time_optimization_tpu_torch.utils.config import CompromiseConfig, CornerConfig

# Defaults from the central config (reference values: src/__main__.py:109-112
# for corners, src/trajectory.py:99 for epsilon)
_CORNERS = CornerConfig()
_COMPROMISE = CompromiseConfig()
K_MIN, PROXIMITY, LENGTH = _CORNERS.k_min, _CORNERS.proximity, _CORNERS.length
EPS_MIN, EPS_MAX = _COMPROMISE.eps_min, _COMPROMISE.eps_max
SOLVERS = ("scan", "assoc", "fused")
#: Sweeps of the "assoc" profile on full-resolution lines.  Its frozen-
#: coefficient scans reach the sequential profile in 20-40 sweeps along the
#: lap-time descent of tbr18 on buckmore (float32 and float64, CPU), more
#: than the searches' 16 on their smoother decongested lines; with 16 the
#: descent meets a profile up to 0.17 s off the oracle, its line searches
#: fail and it ends at 43.4 s, with 48 at 36.44 s (JAX's scan: 36.436 s).
ASSOC_SWEEPS = 48


def _check_solver(solver: str) -> None:
    if solver not in SOLVERS:
        raise ValueError(f"solver {solver!r} is not one of {SOLVERS}")


def _grad_solver(solver: str) -> str:
    _check_solver(solver)
    return "assoc" if solver == "fused" else solver  # the kernel is forward-only


def _linspace(lo: float, hi: float, n: int, dtype, device=None) -> torch.Tensor:
    """`jnp.linspace(lo, hi, n, dtype=dtype)` bit for bit: lo·(1 − t) + hi·t
    with t = i/(n−1), and hi itself last."""
    if n == 1:
        return torch.full((1,), lo, dtype=dtype, device=device)
    t = torch.arange(n - 1, dtype=dtype, device=device) / (n - 1)
    return torch.cat([lo * (1 - t) + hi * t, torch.full((1,), hi, dtype=dtype, device=device)])


# --------------------------------------------------------------------------- core pipeline
def path_and_samples(track: Track, alphas: torch.Tensor):
    """The racing-line spline of alphas (*lead, size) and its fixed-count
    sample grid over the current path length (*lead, ns)
    (src/trajectory.py:35,45)."""
    sp = track.path_spline(alphas)
    return sp, spline.uniform_samples(sp.length, track.ns)


def _profile_of(vehicle, s, k, length, closed: bool, solver: str):
    """Velocity profile over s[..., :-1] with |κ| k (*lead, ns-1)."""
    if solver == "scan":
        return velocity.solve_profile(vehicle, s[..., :-1], k, length, closed)
    if solver == "assoc":
        return velocity.solve_profile_parallel(vehicle, s[..., :-1], k, length, closed, ASSOC_SWEEPS)
    _check_solver(solver)
    n = k.shape[-1]
    v = velocity_batch.solve_profile_batch(vehicle, s[..., :-1].reshape(-1, n),
                                           k.reshape(-1, n).contiguous(), length.reshape(-1), closed)
    return v.reshape(k.shape)


def profile(track: Track, vehicle, sp: spline.Spline2D, s: torch.Tensor, solver: str = "scan"):
    """Velocity profile over s[..., :-1] (reference src/trajectory.py:47-52)."""
    k = spline.curvature(sp, s[..., :-1], signed=False)
    return _profile_of(vehicle, s, k, sp.length, track.closed, solver)


def lap_time_of(track: Track, vehicle, alphas: torch.Tensor, solver: str = "scan") -> torch.Tensor:
    """Lap time (*lead,) of alphas (*lead, size), differentiable unless
    `solver="fused"`."""
    sp, s = path_and_samples(track, alphas)
    return velocity.lap_time(s, profile(track, vehicle, sp, s, solver))


@torch.no_grad()
def evaluate(track: Track, vehicle, alphas: torch.Tensor, solver: str = "scan"):
    """Diagnostics for reporting: (lap_time, path_length, v, s)."""
    sp, s = path_and_samples(track, alphas)
    v = profile(track, vehicle, sp, s, solver)
    return velocity.lap_time(s, v), sp.length, v, s


# --------------------------------------------------------------------------- objectives
def gamma2_objective(track: Track, alphas: torch.Tensor) -> torch.Tensor:
    sp, s = path_and_samples(track, alphas)
    return spline.gamma2(sp, s)


def compromise_objective(track: Track, alphas: torch.Tensor, eps) -> torch.Tensor:
    sp, s = path_and_samples(track, alphas)
    return (1.0 - eps) * spline.gamma2(sp, s) + eps * sp.length


# --------------------------------------------------------------------------- methods
def _one(res: optimize.MinimizeResult) -> optimize.MinimizeResult:
    return optimize.MinimizeResult(*(t[0] for t in res))


def _start(track: Track, k: int) -> torch.Tensor:
    return torch.full((k, track.size), 0.5, dtype=track.left.dtype, device=track.left.device)


def minimise_curvature(track: Track, max_iter: int = 400, linesearch: str = "zoom"):
    """Γ²-minimising path by bounded L-BFGS on autograd gradients (vs
    src/trajectory.py:60-75)."""
    return _one(optimize.minimize_bounded(lambda a: gamma2_objective(track, a), _start(track, 1),
                                          max_iter=max_iter, linesearch=linesearch))


def _minimise_compromises(track: Track, eps: torch.Tensor, max_iter: int, linesearch: str):
    """(1−ε)Γ² + ε·length for every ε of eps (K,), one instance each."""
    eps = eps.to(dtype=track.left.dtype, device=track.left.device)
    return optimize.minimize_bounded(lambda a: compromise_objective(track, a, eps),
                                     _start(track, eps.shape[0]), max_iter=max_iter,
                                     linesearch=linesearch)


def minimise_compromise(track: Track, eps, max_iter: int = 400, linesearch: str = "zoom"):
    """(1−ε)Γ² + ε·length (vs src/trajectory.py:77-97)."""
    eps = torch.as_tensor(eps, dtype=track.left.dtype, device=track.left.device).reshape(1)
    return _one(_minimise_compromises(track, eps, max_iter, linesearch))


def _compromise_sweep(track: Track, vehicle, eps_grid: torch.Tensor, max_iter: int = 400,
                      linesearch: str = "zoom", solver: str = "scan"):
    """For every ε of the grid (B,), optimise the compromise and score the
    line's lap time (one batch of B; kernel 3 with `solver="fused"`).
    Returns (alphas (B, size), lap times (B,))."""
    res = _minimise_compromises(track, eps_grid, max_iter, linesearch)
    return res.x, evaluate(track, vehicle, res.x, solver)[0]


def minimise_optimal_compromise(track: Track, vehicle, eps_min: float = EPS_MIN,
                                eps_max: float = EPS_MAX, n_grid: int = 16, n_refine: int = 1,
                                max_iter: int = 400, linesearch: str = "zoom",
                                solver: str = "scan"):
    """Optimal-ε compromise by a batched grid sweep and `n_refine` zooms
    into the best cell (the reference nests a scalar search around a full
    L-BFGS per ε, src/trajectory.py:99-126).  Returns (alphas, epsilon,
    history), history the (ε, lap time) log of the reference's
    `epsilon_history`."""
    lo, hi = float(eps_min), float(eps_max)
    history = []
    best = None
    for _ in range(1 + n_refine):
        eps_grid = _linspace(lo, hi, n_grid, torch.float64)
        alphas_b, times_b = _compromise_sweep(track, vehicle, eps_grid, max_iter, linesearch, solver)
        times = times_b.cpu().numpy()
        grid = eps_grid.numpy()
        history.extend(zip(grid.tolist(), times.tolist()))
        i = int(np.argmin(times))
        cand = (float(times[i]), float(grid[i]), alphas_b[i])
        if best is None or cand[0] < best[0]:
            best = cand
        cell = (hi - lo) / (n_grid - 1)
        lo = max(float(eps_min), float(grid[i]) - cell)
        hi = min(float(eps_max), float(grid[i]) + cell)
    _, epsilon, alphas = best
    return alphas, epsilon, np.asarray(history)


def minimise_lap_time(track: Track, vehicle, max_iter: int = 300, linesearch: str = "zoom",
                      chunk: int = 50, solver: str = "scan"):
    """Minimise lap time directly through the differentiable profile (vs
    src/trajectory.py:128-146, which differentiates the 3-pass solve
    numerically), through `optimize.minimize_bounded_chunked` in chunks of
    `chunk` iterations as the JAX package: the iterates do not depend on
    `chunk`.  The gradient runs on "assoc" with `solver="fused"`."""
    grad_solver = _grad_solver(solver)
    return _one(optimize.minimize_bounded_chunked(
        lambda a: lap_time_of(track, vehicle, a, grad_solver), _start(track, 1),
        max_iter=max_iter, linesearch=linesearch, chunk=chunk))


# --------------------------------------------------------------------------- corners / estimated
def _centre_samples(track: Track):
    """The centre line's spline, its per-metre sample distances (numpy) and
    those samples as a tensor of the track's dtype."""
    mid = track.mid_spline()
    s = np.linspace(0.0, float(mid.length), track.ns)
    return mid, s, torch.as_tensor(s, dtype=track.left.dtype, device=track.left.device)


@torch.no_grad()
def detect_track_corners(track: Track, k_min=K_MIN, proximity=PROXIMITY, length=LENGTH):
    """Corner detection on the centre line, on the host (reference
    src/track.py:78-80): (control-index corner pairs (nc, 2), sample mask)."""
    mid, s, s_t = _centre_samples(track)
    k = spline.curvature(mid, s_t, signed=False).cpu().numpy()
    control_dists = mid.tk.cpu().numpy()
    return corner_utils.detect_corners(k, s, control_dists, k_min, proximity, length)


def minimise_estimated_compromise(track: Track, vehicle, max_iter: int = 400):
    """ε estimated as 0.406 × the mean corner curvature
    (src/__main__.py:139-147).  Returns (alphas, epsilon)."""
    _, mask = detect_track_corners(track)
    mid, _, s_t = _centre_samples(track)
    with torch.no_grad():
        k = spline.curvature(mid, s_t[torch.as_tensor(mask, device=s_t.device)], signed=False)
    epsilon = float(0.406 * np.mean(k.cpu().numpy()))
    return minimise_compromise(track, epsilon, max_iter=max_iter).x, epsilon


# --------------------------------------------------------------------------- sectors
def _sector_sweep(left_w: torch.Tensor, right_w: torch.Tensor, vehicle, ns_pad: int, n_grid: int,
                  max_iter: int, solver: str = "scan"):
    """Every sector × ε compromise over open sub-tracks as one instance
    batch of nc·n_grid, then one batch of lap scores (kernel 3 with
    `solver="fused"`).  left_w/right_w: (nc, 2, L) padded boundary windows.
    Returns each sector's (alphas (nc, L), epsilon (nc,)) of the best lap
    over its window."""
    _check_solver(solver)
    nc, _, L = left_w.shape
    eps_grid = _linspace(EPS_MIN, EPS_MAX, n_grid, left_w.dtype, left_w.device)
    lw = left_w.repeat_interleave(n_grid, dim=0)  # row r: sector r // n_grid, ε r % n_grid
    diffs = right_w.repeat_interleave(n_grid, dim=0) - lw
    eps = eps_grid.repeat(nc)

    def geometry(alphas):
        sp = spline.fit(lw + alphas[:, None, :] * diffs, closed=False)
        return sp, spline.uniform_samples(sp.length, ns_pad)

    def obj(alphas):
        sp, s = geometry(alphas)
        return (1.0 - eps) * spline.gamma2(sp, s) + eps * sp.length

    x0 = torch.full((nc * n_grid, L), 0.5, dtype=left_w.dtype, device=left_w.device)
    res = optimize.minimize_bounded(obj, x0, max_iter=max_iter)
    with torch.no_grad():
        sp, s = geometry(res.x)
        k = spline.curvature(sp, s[:, :-1], signed=False)
        times = velocity.lap_time(s, _profile_of(vehicle, s, k, sp.length, False, solver))
    i = torch.argmin(times.reshape(nc, n_grid), dim=1)
    return res.x.reshape(nc, n_grid, L)[torch.arange(nc, device=i.device), i], eps_grid[i]


def sector_windows(track: Track, corners: np.ndarray):
    """The sector windows of `optimise_sectors`: per sector its span
    (a, b, c, d) and control indices [previous corner's exit → next
    corner's entry), every window padded to the longest by continuing
    around the track, as (spans, idx_windows, left_w (nc, 2, L), right_w,
    ns_pad), ns_pad the per-metre sample count of the longest."""
    nc = corners.shape[0]
    n = track.size
    left = track.left.cpu().numpy()
    right = track.right.cpu().numpy()
    spans, idx_windows = [], []
    for i in range(nc):
        a = int(corners[(i - 1) % nc, 1])
        d = int(corners[(i + 1) % nc, 0])
        idx_windows.append(corner_utils.idx_modulo(a, d, n))
        spans.append((a, int(corners[i, 0]), int(corners[i, 1]), d))
    L = max(len(w) for w in idx_windows)
    padded = np.stack([np.array([(w[0] + j) % n for j in range(L)], dtype=int) for w in idx_windows])
    as_t = lambda x: torch.as_tensor(x.transpose(1, 0, 2), device=track.left.device).contiguous()
    mids = 0.5 * (left[:, padded] + right[:, padded])  # (2, nc, L)
    seglen = np.hypot(*np.diff(mids, axis=2)).sum(axis=1)
    ns_pad = int(math.ceil(seglen.max())) + 1
    return spans, idx_windows, as_t(left[:, padded]), as_t(right[:, padded]), ns_pad


def optimise_sectors(track: Track, vehicle, k_min=K_MIN, proximity=PROXIMITY, length=LENGTH,
                     n_grid: int = 8, max_iter: int = 300, solver: str = "scan"):
    """Sector-parallel compromise optimisation with cross-faded merging (vs
    the reference's `Pool(os.cpu_count()-1)` fan-out, src/trajectory.py:148-213):
    the windows of `sector_windows` optimised as open sub-tracks in one
    batch and merged with the reference's linear cross-fade over the
    straights (src/trajectory.py:197-202).  Returns (alphas (size,),
    epsilon per sector (nc,), corners (nc, 2))."""
    corners, _ = detect_track_corners(track, k_min, proximity, length)
    if corners.shape[0] == 0:
        raise ValueError("no corners detected; sector optimization is undefined")
    n = track.size
    spans, idx_windows, left_w, right_w, ns_pad = sector_windows(track, corners)
    alphas_w, eps_w = _sector_sweep(left_w, right_w, vehicle, ns_pad, n_grid, max_iter, solver)
    alphas_w = alphas_w.cpu().numpy()

    alphas = np.zeros(n)
    for i, (a, b, c, d) in enumerate(spans):
        span = (d - a) % n
        weights = np.ones(span)
        head = (b - a) % n
        tail = (d - c) % n
        if head:
            weights[:head] = np.linspace(0, 1, head)
        if tail:
            weights[span - tail:] = np.linspace(1, 0, tail)
        alphas[idx_windows[i]] += alphas_w[i, :span] * weights
    return (torch.as_tensor(alphas, dtype=track.left.dtype, device=track.left.device),
            eps_w.cpu().numpy(), corners)
