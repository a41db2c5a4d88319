"""Global racing-line search: batched nonlinear multi-start + Bayesian
optimisation — port of `lap_time_optimization_tpu/optim/global_search.py`.

Capability parity with reference src/trajectory_bayesian_nonlinear.py (tbn):

* **Nonlinear** (tbn.py:230-269): one batched evaluation of `n_random`
  random candidates, then a batched bounded L-BFGS refinement of the
  `n_refine` best, on autograd gradients of the lap time.
* **Bayesian** (tbn.py:120-205): each round fits a GP to the dataset,
  proposes a batch (smooth and white perturbations of the incumbent at three
  scales + uniform exploration), evaluates the true lap times in one batch,
  polishes the incumbent by L-BFGS, and stops on the reference's rule:
  enough samples and std(last 10 GP σ) < 1e-3 (tbn.py:195-200).

Both optimise the decongested (every-3rd-control-point) alphas in
[0, 0.99], like the reference (tbn.py:142,172).

`solver` picks the velocity profile of the lap times: "scan" (the
sequential oracle, the default), "assoc" (the log-depth schedule) or
"fused", the batched forward route of the JAX package's "pallas": the
geometry with the O(n) tridiag spline fit, then the hand-written kernel
`ops/velocity_batch.solve_profile_batch`.  The kernel is forward-only, so
gradients (the refinement and the polish) then run on "assoc", as in JAX.
The searches draw their random numbers from a `torch.Generator` on the
track's device seeded with `seed`; its numbers differ from `jax.random`'s,
so the two packages are held to lap-time gates, not to the same trajectory.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from lap_time_optimization_tpu_torch.ops import gp as gp_ops
from lap_time_optimization_tpu_torch.ops import optimize, spline, velocity, velocity_batch
from lap_time_optimization_tpu_torch.parallel.distributed import gather_rows, shard_rows
from lap_time_optimization_tpu_torch.track import Track
from lap_time_optimization_tpu_torch.utils import checkpoint as ckpt
from lap_time_optimization_tpu_torch.utils.profiling import Heartbeat

ALPHA_LO, ALPHA_HI = 0.0, 0.99  # reference bounds, tbn.py:172,209
SOLVERS = ("scan", "assoc", "fused")


# --------------------------------------------------------------------- pipeline
def _geometry(track: Track, alphas: torch.Tensor, method: str | None = None):
    """(s (*lead, ns), |κ| at s[..., :-1], lap length) of the spline through
    the decongested control points of alphas (*lead, n_dec)."""
    sp = spline.fit(track.control_points_decongested(alphas), track.closed, method)
    s = spline.uniform_samples(sp.length, track.ns)
    return s, spline.curvature(sp, s[..., :-1], signed=False), sp.length


def decongested_lap_time(track: Track, vehicle, alphas_dec: torch.Tensor,
                         solver: str = "scan") -> torch.Tensor:
    """Lap time of the spline through the decongested control subset
    (reference `calcMinTime`, tbn.py:65-80), for alphas (*lead, n_dec).
    `solver`: "scan" (sequential oracle) or "assoc" (log-depth schedule,
    the gradient path of the searches)."""
    s, k, length = _geometry(track, alphas_dec)
    if solver == "scan":
        v = velocity.solve_profile(vehicle, s[..., :-1], k, length, track.closed)
    elif solver == "assoc":
        v = velocity.solve_profile_parallel(vehicle, s[..., :-1], k, length, track.closed)
    else:
        raise ValueError(f"decongested_lap_time: solver {solver!r} is not 'scan' or 'assoc'")
    return velocity.lap_time(s, v)


def evaluate_decongested(track: Track, vehicle, alphas_dec: torch.Tensor):
    """(lap time, spline length, profile v, samples s) by the scan oracle."""
    s, k, length = _geometry(track, alphas_dec)
    v = velocity.solve_profile(vehicle, s[..., :-1], k, length, track.closed)
    return velocity.lap_time(s, v), length, v, s


@torch.no_grad()
def _batch_lap_times(track: Track, vehicle, alphas_batch: torch.Tensor,
                     solver: str = "scan") -> torch.Tensor:
    """Lap times (B,) of alphas (B, n_dec) with NaN → +inf: a degenerate
    candidate (a float32 spline fit through a self-crossing control polygon
    can NaN) must lose every argmin/argsort, not poison it.

    solver="fused": the geometry with `spline.FIT_METHOD_CLOSED_BATCHED`,
    then `velocity_batch.solve_profile_batch` (the CUDA kernel on the card,
    its plain twin on the CPU)."""
    if solver == "fused":
        s, k, length = _geometry(track, alphas_batch, spline.FIT_METHOD_CLOSED_BATCHED)
        v = velocity_batch.solve_profile_batch(vehicle, s[:, :-1], k, length, track.closed)
        times = velocity.lap_time(s, v)
    else:
        times = decongested_lap_time(track, vehicle, alphas_batch, solver)
    return torch.where(torch.isnan(times), torch.full_like(times, torch.inf), times)


def _grad_solver(solver: str) -> str:
    if solver not in SOLVERS:
        raise ValueError(f"solver {solver!r} is not one of {SOLVERS}")
    return "assoc" if solver == "fused" else solver  # the kernel is forward-only


def _refine(track: Track, vehicle, x0: torch.Tensor, max_iter: int,
            solver: str) -> optimize.MinimizeResult:
    """Bounded ladder L-BFGS of every row of x0 (K, n_dec) to convergence or
    `max_iter`, each row its own instance (MinimizeResult over K)."""
    init, run, fin = optimize.bounded_stepper(
        lambda a: decongested_lap_time(track, vehicle, a, solver), lo=ALPHA_LO, hi=ALPHA_HI,
        max_iter=max_iter, dtype=track.left.dtype, linesearch="ladder")
    return fin(run(init(x0), max_iter))


def _uniform(gen: torch.Generator, shape, track: Track) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, dtype=track.left.dtype, device=track.left.device)
    return ALPHA_LO + (ALPHA_HI - ALPHA_LO) * u


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.full_like(x, torch.inf))


# -------------------------------------------------------------------- nonlinear
def _nonlinear_select(track: Track, vehicle, cands: torch.Tensor, n_refine: int, solver: str,
                      mesh=None):
    """Lap times of every candidate (each dp rank of `mesh` scores its block),
    their order, and the n_refine best candidates."""
    times = gather_rows(mesh, _batch_lap_times(track, vehicle, shard_rows(mesh, cands, pad=True), solver),
                        cands.shape[0])
    order = torch.argsort(times, stable=True)
    return times, order, cands[order[:n_refine]]


def nonlinear(track: Track, vehicle, seed: int = 0, n_random: int = 1024, n_refine: int = 10,
              max_iter: int = 100, solver: str = "scan", mesh=None):
    """Batched random search + batched gradient refinement (vs tbn.py:230-269).
    Returns (best alphas (n_dec,), best lap time).

    With `mesh` (a `DeviceMesh`, `parallel.distributed`), the candidate
    selection and the refinement fan-out shard over its 'dp' ranks: each
    rank scores and refines its block of rows (the last row repeated where
    dp does not divide them), one `all_gather` each gives every rank all the
    results, and every rank returns the same best lap."""
    grad_solver = _grad_solver(solver)
    gen = torch.Generator(device=track.left.device)
    gen.manual_seed(seed)
    cands = _uniform(gen, (n_random, track.n_decongested), track)
    times, order, seeds = _nonlinear_select(track, vehicle, cands, n_refine, solver, mesh)
    res = _refine(track, vehicle, shard_rows(mesh, seeds, pad=True), max_iter, grad_solver)
    res = optimize.MinimizeResult(*(gather_rows(mesh, t, seeds.shape[0]) for t in res))
    f_ref = _finite(res.fun)
    best_ref = torch.argmin(f_ref)
    best_rand = order[0]
    use_refined = f_ref[best_ref] < times[best_rand]
    best_x = torch.where(use_refined, res.x[best_ref], cands[best_rand])
    best_f = torch.minimum(f_ref[best_ref], times[best_rand])
    return best_x, float(best_f)


# --------------------------------------------------------------------- bayesian
def _smooth_chol(d: int, dtype, device, corr_len: float = 2.0) -> torch.Tensor:
    """Cholesky of an RBF covariance over (cyclic) control indices: racing
    lines are smooth, so correlated perturbations explore the useful
    subspace far better than white noise.  NaN where the cyclic kernel is
    not positive definite (few control points), as JAX's Cholesky: the
    smooth proposals are then NaN and score no lap."""
    idx = torch.arange(d, device=device)
    dist = torch.abs(idx[:, None] - idx[None, :]).to(dtype)
    dist = torch.minimum(dist, d - dist)  # cyclic
    K = torch.exp(-0.5 * (dist / corr_len) ** 2) + 1e-6 * torch.eye(d, dtype=dtype, device=device)
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where(info == 0, L, torch.full_like(L, torch.nan))


def _propose(gen: torch.Generator, incumbent: torch.Tensor, n_local: int, n_uniform: int):
    """One acquisition round's candidates: correlated (even rows) and white
    (odd rows) perturbations of the incumbent at scales 0.02/0.08/0.25, plus
    uniform exploration.  (3·n_local + n_uniform, d)."""
    d = incumbent.shape[0]
    dtype, device = incumbent.dtype, incumbent.device
    normal = lambda: torch.randn((3, n_local, d), generator=gen, dtype=dtype, device=device)
    scales = torch.tensor([0.02, 0.08, 0.25], dtype=dtype, device=device)[:, None, None]
    smooth = (normal() @ _smooth_chol(d, dtype, device).T) * scales
    white = normal() * scales
    even = (torch.arange(n_local, device=device) % 2 == 0)[None, :, None]
    local = torch.clamp(incumbent + torch.where(even, smooth, white), ALPHA_LO, ALPHA_HI)
    u = torch.rand((n_uniform, d), generator=gen, dtype=dtype, device=device)
    return torch.cat([local.reshape(-1, d), ALPHA_LO + (ALPHA_HI - ALPHA_LO) * u], dim=0)


def _gp_targets(y_data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """GP targets from the padded dataset: masked rows → 0, and a non-finite
    observation → the worst finite one, so a bad sample marks its region as
    poor instead of NaN-ing the Cholesky; if no live observation is finite,
    0 (a flat GP)."""
    finite = torch.isfinite(y_data) & mask
    worst = torch.max(torch.where(finite, y_data, torch.full_like(y_data, -torch.inf)))
    worst = torch.where(torch.isfinite(worst), worst, torch.zeros_like(worst))
    y = torch.where(torch.isfinite(y_data), y_data, worst)
    return torch.where(mask, y, torch.zeros_like(y))


def _round_pre(x_data, y_data, count: int):
    mask = torch.arange(x_data.shape[0], device=x_data.device) < count
    return mask, x_data[torch.argmin(y_data)]


def _best_candidate(cands, times):
    j = torch.argmin(times)
    return j, cands[j], times[j]


def _merge_polish(times, j, w_star, x_pol, f_pol):
    better = f_pol < times[j]
    w_star = torch.where(better, x_pol, w_star)
    t_star = torch.minimum(times[j], f_pol)
    times = times.clone()
    times[j] = t_star
    return w_star, times, t_star


def _record(x_data, y_data, count: int, w_star, t_star):
    x_data, y_data = x_data.clone(), y_data.clone()
    x_data[count] = w_star
    y_data[count] = t_star
    return x_data, y_data


def _init_seeds(x_data, y_init, k: int):
    return x_data[torch.argsort(y_init, stable=True)[:k]]


def _record_init_polish(x_data, y_data, res_x, f_pol, n_init: int, k: int):
    x_data, y_data = x_data.clone(), y_data.clone()
    x_data[n_init:n_init + k] = res_x
    y_data[n_init:n_init + k] = f_pol
    return x_data, y_data, torch.argmin(f_pol)


def _key(x: torch.Tensor) -> bytes:
    return x.detach().cpu().numpy().tobytes()


def bayesian(
    track: Track,
    vehicle,
    seed: int = 0,
    n_init: int = 256,
    n_local: int = 64,
    n_uniform: int = 64,
    max_rounds: int = 60,
    sigma_window: int = 10,
    sigma_tol: float = 1e-3,
    min_samples: int = 25,
    checkpoint_path: str | None = None,
    polish_every: int = 1,
    polish_iters: int = 200,
    heartbeat_path: str | None = None,
    solver: str = "scan",
    n_polish_starts: int = 10,
    polish_all_rounds: bool = False,
):
    """GP-guided global search with true-objective acquisition (vs tbn.py:120-205).

    Budgets as in the JAX package: one batch of `n_init` random inits, then
    a batched multi-start polish of the top `n_polish_starts` (all k results
    join the dataset); every `polish_every` rounds a batched polish of the
    incumbent plus the best not-yet-polished dataset points, up to
    `polish_iters` L-BFGS iterations.  A memo maps each polished point, and
    each CONVERGED polish output, to its result, so a repeating incumbent
    costs nothing (unless `polish_all_rounds`).

    Returns (best alphas (n_dec,), best lap time, info).  With
    `checkpoint_path` the dataset, σ history and generator state are saved
    every round, and a run over the same parameterisation whose remaining
    rounds fit the capacity resumes exactly."""
    timings = {"init": 0.0, "gp_fit": 0.0, "propose": 0.0, "polish": 0.0,
               "polish_calls": 0, "polish_iters": 0}
    t_start = time.perf_counter()
    grad_solver = _grad_solver(solver)
    hb = Heartbeat(heartbeat_path)
    device, dtype = track.left.device, track.left.dtype
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d = track.n_decongested
    k_starts = min(n_polish_starts, n_init) if polish_every else 0
    cap = n_init + max_rounds + k_starts

    # resume check first: the init batch and its polish are the most
    # expensive phases and a resume would overwrite them
    resume_state = None
    if checkpoint_path and ckpt.exists(checkpoint_path):
        state = ckpt.load(checkpoint_path)
        need = int(state["count"]) + max(0, max_rounds - int(state["round"]))
        if state["x"].shape[1:] == (d,) and need <= cap:
            resume_state = state
        else:
            warnings.warn(
                f"checkpoint at {checkpoint_path} (dataset {state['x'].shape}, count "
                f"{int(state['count'])}, round {int(state['round'])}) cannot resume into this "
                f"run (dimension {d}, capacity {cap}); restarting the search from scratch",
                stacklevel=2,
            )

    x_data = torch.zeros((cap, d), dtype=dtype, device=device)
    y_data = torch.full((cap,), torch.inf, dtype=dtype, device=device)
    count = n_init
    start_round = 1
    sigma_hist: list[float] = []
    polish_memo: dict[bytes, tuple] = {}

    if resume_state is None:
        x_init = _uniform(gen, (n_init, d), track)
        x_data[:n_init] = x_init
        y_data[:n_init] = _batch_lap_times(track, vehicle, x_init, solver)
        _sync(device)
    timings["init"] = time.perf_counter() - t_start

    if k_starts and resume_state is None:
        t = time.perf_counter()
        seeds = _init_seeds(x_data, y_data[:n_init], k_starts)
        res = _refine(track, vehicle, seeds, polish_iters, grad_solver)
        f_pol = _finite(res.fun)
        x_data, y_data, b = _record_init_polish(x_data, y_data, res.x, f_pol, n_init, k_starts)
        count = n_init + k_starts
        b = int(b)
        if int(res.n_iter[b]) < polish_iters:  # converged → fixed point
            polish_memo[_key(res.x[b])] = (res.x[b], f_pol[b])
        timings["polish_calls"] += 1
        timings["polish_iters"] += int(res.n_iter.max())
        _sync(device)
        timings["polish"] += time.perf_counter() - t

    if resume_state is not None:
        count = int(resume_state["count"])
        x_data[:count] = torch.as_tensor(resume_state["x"][:count], dtype=dtype, device=device)
        y_data[:count] = torch.as_tensor(resume_state["y"][:count], dtype=dtype, device=device)
        start_round = int(resume_state["round"]) + 1
        sigma_hist = [float(v) for v in np.asarray(resume_state["sigma_hist"], dtype=np.float64)]
        gen.set_state(torch.from_numpy(np.asarray(resume_state["rng_state"], dtype=np.uint8)))

    rounds = start_round - 1
    prev_ell = torch.tensor(1.0, dtype=dtype, device=device)
    for rounds in range(start_round, max_rounds + 1):
        mask, incumbent = _round_pre(x_data, y_data, count)
        t = time.perf_counter()
        # the previous MLE joins the grid, so a refit can only improve on it
        model = gp_ops.fit(x_data, _gp_targets(y_data, mask), mask=mask, ell0=prev_ell)
        prev_ell = model.length_scale
        _sync(device)
        timings["gp_fit"] += time.perf_counter() - t
        t = time.perf_counter()
        cands = _propose(gen, incumbent, n_local, n_uniform)
        times = _batch_lap_times(track, vehicle, cands, solver)
        j, w_star, t_star = _best_candidate(cands, times)
        _sync(device)
        timings["propose"] += time.perf_counter() - t
        if polish_every and rounds % polish_every == 0:
            t = time.perf_counter()
            inc_key = _key(incumbent)
            if inc_key in polish_memo and not polish_all_rounds:
                x_pol, f_pol = polish_memo[inc_key]
            else:
                # batched multi-start: the incumbent + the best distinct
                # not-yet-polished dataset points, k descents at once
                k = max(1, k_starts or n_polish_starts)
                y_host = y_data.cpu().numpy()
                x_host = x_data.cpu().numpy()
                seeds = [incumbent]
                seen = {inc_key}
                for i2 in np.argsort(y_host, kind="stable"):
                    if len(seeds) >= k:
                        break
                    if not np.isfinite(y_host[i2]):
                        continue
                    key = x_host[i2].tobytes()
                    if key in seen or key in polish_memo:
                        continue
                    seen.add(key)
                    seeds.append(x_data[i2])
                while len(seeds) < k:  # pad: repeated rows are harmless
                    seeds.append(seeds[0])
                seeds = torch.stack(seeds)
                res = _refine(track, vehicle, seeds, polish_iters, grad_solver)
                f_all = _finite(res.fun)
                b2 = int(torch.argmin(f_all))
                x_pol, f_pol = res.x[b2], f_all[b2]
                timings["polish_calls"] += 1
                timings["polish_iters"] += int(res.n_iter.max())
                n_iter = res.n_iter.cpu().numpy()
                for i2 in range(seeds.shape[0]):
                    out_i = (res.x[i2], f_all[i2])
                    polish_memo[_key(seeds[i2])] = out_i
                    if n_iter[i2] < polish_iters:  # converged: its own fixed point
                        polish_memo[_key(res.x[i2])] = out_i
            w_star, times, t_star = _merge_polish(times, j, w_star, x_pol, f_pol)
            _sync(device)
            timings["polish"] += time.perf_counter() - t
        _, sig = gp_ops.predict(model, w_star[None, :])
        sigma_hist.append(float(sig[0]))
        x_data, y_data = _record(x_data, y_data, count, w_star, t_star)
        count += 1
        if heartbeat_path:
            hb.beat(rounds, best=float(torch.min(y_data)), n_samples=count)
        if checkpoint_path:
            ckpt.save(checkpoint_path, x=x_data.cpu().numpy(), y=y_data.cpu().numpy(),
                      count=count, round=rounds, sigma_hist=np.asarray(sigma_hist),
                      rng_state=gen.get_state().numpy())
        if count > min_samples and len(sigma_hist) >= sigma_window:
            if float(np.std(sigma_hist[-sigma_window:])) < sigma_tol:
                break

    best = int(torch.argmin(y_data))
    timings["total"] = time.perf_counter() - t_start
    info = dict(rounds=rounds, n_samples=count, sigma_history=np.asarray(sigma_hist),
                timings={k: round(v, 3) for k, v in timings.items()})
    return x_data[best], float(y_data[best]), info
