"""Gaussian-process regression (Matérn-5/2) for the Bayesian search — port
of `lap_time_optimization_tpu/ops/gp.py`.

Replaces sklearn's `GaussianProcessRegressor(kernel=Matern(nu=2.5),
n_restarts_optimizer=10)` (reference src/trajectory_bayesian_nonlinear.py:161-162).
The length scale is fitted by a deterministic two-stage grid over the 1-D
marginal likelihood (65 then 64 scales, each a batched Cholesky), not by
restarted quasi-Newton, so the fit takes no random key.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def _jitter(dtype) -> float:
    """Cholesky jitter: sklearn's default alpha=1e-10 in float64, 3e-5 in
    float32, where the dataset's near-duplicate polished incumbents make K
    numerically singular."""
    return 1e-10 if torch.finfo(dtype).bits >= 64 else 3e-5


def matern52(x1: torch.Tensor, x2: torch.Tensor, length_scale) -> torch.Tensor:
    """Matérn ν=5/2 kernel matrix for x1 (n, d), x2 (m, d); a length scale
    of shape (G,) gives (G, n, m)."""
    d2 = torch.sum((x1[:, None, :] - x2[None, :, :]) ** 2, dim=-1)
    r = torch.sqrt(torch.clamp(d2, min=1e-30))
    ell = torch.as_tensor(length_scale, dtype=x1.dtype, device=x1.device)
    c = math.sqrt(5.0) * r / ell[..., None, None]
    return (1.0 + c + c * c / 3.0) * torch.exp(-c)


@dataclasses.dataclass(frozen=True)
class GP:
    x_train: torch.Tensor  # (n, d)
    chol: torch.Tensor  # (n, n) lower Cholesky of K + jitter I
    weights: torch.Tensor  # (n,) K^{-1} y
    y_train: torch.Tensor  # (n,)
    length_scale: torch.Tensor  # scalar
    mask: torch.Tensor  # (n,) real-row mask for padded datasets


def _masked_kernel(x, ell, mask):
    """K + jitter for each length scale in `ell` (G,) → (G, n, n), padded
    rows/cols turned into decoupled unit-variance points: they add a
    constant to the likelihood and nothing to predictions, so padded fits
    equal unpadded ones."""
    n = x.shape[0]
    K = matern52(x, x, ell)
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    K = torch.where(mask[:, None] & mask[None, :], K, torch.zeros_like(K))
    K = torch.where(eye.bool() & ~mask[:, None], eye, K)
    return K + _jitter(x.dtype) * eye


def _nll(log_ell: torch.Tensor, x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Negative log marginal likelihood at each log length scale (G,); NaN
    where K + jitter is not positive definite (as JAX's NaN Cholesky)."""
    n = x.shape[0]
    L, info = torch.linalg.cholesky_ex(_masked_kernel(x, torch.exp(log_ell), mask))
    alpha = torch.cholesky_solve(y.expand(L.shape[:-2] + (n,))[..., None], L)[..., 0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    nll = 0.5 * torch.sum(y * alpha, dim=-1) + 0.5 * logdet + 0.5 * n * math.log(2.0 * math.pi)
    return torch.where(info == 0, nll, torch.full_like(nll, torch.nan))


def fit(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor | None = None,
        ell0: torch.Tensor | None = None, n_grid: int = 64) -> GP:
    """Maximum-likelihood length scale by a two-stage grid, then factorise.

    The length scale is one isotropic scale in [1e-2, 1e2] (sklearn's
    bracket narrowed for conditioning; the alphas live in a unit box).
    Stage 1 factorises `n_grid` log-spaced scales plus `ell0` (default 1.0,
    sklearn's initial value) in one batched Cholesky; stage 2 refines
    `n_grid` scales across the two cells around the stage-1 argmin.  `mask`
    marks the real rows of a padded dataset."""
    if mask is None:
        mask = torch.ones((x.shape[0],), dtype=torch.bool, device=x.device)
    y = torch.where(mask, y, torch.zeros_like(y))
    lo, hi = math.log(1e-2), math.log(1e2)
    first = (torch.zeros((1,), dtype=x.dtype, device=x.device) if ell0 is None
             else torch.log(torch.as_tensor(ell0, dtype=x.dtype, device=x.device)).reshape(1))
    finite = lambda f: torch.where(torch.isfinite(f), f, torch.full_like(f, torch.inf))

    grid1 = torch.cat([torch.linspace(lo, hi, n_grid, dtype=x.dtype, device=x.device), first])
    f1 = finite(_nll(grid1, x, y, mask))
    c = grid1[torch.argmin(f1)]
    h = (hi - lo) / (n_grid - 1)
    grid2 = torch.linspace(float(c - h), float(c + h), n_grid, dtype=x.dtype, device=x.device)
    f2 = finite(_nll(grid2, x, y, mask))

    log_ells = torch.cat([grid1, grid2])
    ell = torch.exp(log_ells[torch.argmin(torch.cat([f1, f2]))])
    # if every scale failed (pathological K), keep the first start
    ell = torch.where(torch.isfinite(ell) & (ell > 0), ell, torch.exp(first[0]))
    L = torch.linalg.cholesky_ex(_masked_kernel(x, ell, mask))[0]
    weights = torch.cholesky_solve(y[:, None], L)[:, 0]
    return GP(x_train=x, chol=L, weights=weights, y_train=y, length_scale=ell, mask=mask)


def predict(gp: GP, x_query: torch.Tensor):
    """Posterior mean and std at x_query (m, d)."""
    kq = matern52(gp.x_train, x_query, gp.length_scale)  # (n, m)
    kq = torch.where(gp.mask[:, None], kq, torch.zeros_like(kq))  # padded rows carry no signal
    mean = kq.T @ gp.weights
    v = torch.linalg.solve_triangular(gp.chol, kq, upper=False)  # (n, m)
    var = 1.0 - torch.sum(v * v, dim=0)  # Matérn prior variance is 1 at r=0
    return mean, torch.sqrt(torch.clamp(var, min=0.0))
