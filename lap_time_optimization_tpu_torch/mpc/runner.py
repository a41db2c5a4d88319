"""Closed-loop NMPC driver: solve → clip → plant step → warm-start shift.

Port of `lap_time_optimization_tpu/mpc/runner.py` (single stream).  Each
control cycle warm-starts the AL-iLQR from the shifted previous solution,
applies the first input, clipped to the actuator rate and box limits, and
integrates the plant (plant == model, like the reference's do_mpc simulator
over the same ODE).  The loop is eager PyTorch on the model's device; it
makes no host sync, so outputs are written into preallocated device tensors
and only `applied_violation` / `to_sim_results` copy to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lap_time_optimization_tpu_torch.models.bicycle import NU, NX
from lap_time_optimization_tpu_torch.mpc import solver as solver_mod
from lap_time_optimization_tpu_torch.mpc.solver import n_con

#: Reference initial state [s, n, mu, vx, vy, r, steer, throttle]
#: (src/mpc.py:107-110)
X0_REFERENCE = np.array([0.0, 0.0, 0.0, 5.0, 0.0, 0.0, 0.0, 0.1])


class SimResult(NamedTuple):
    xs: torch.Tensor  # (steps+1, NX) states (x[0] = x0)
    us: torch.Tensor  # (steps+1, NU) applied inputs (u[0] = 0)
    costs: torch.Tensor  # (steps,) OCP cost per solve
    violations: torch.Tensor  # (steps,) max constraint violation per solve
    sdot: torch.Tensor  # (steps,) track progress rate per step


def _presolve(model, p, cfg, x0):
    """Burn in the t=0 warm start (do_mpc's set_initial_guess analogue,
    reference src/mpc.py:118) and return the initial carry."""
    N = cfg.horizon
    us_warm = x0.new_zeros((N, NU))
    lam_warm = x0.new_zeros((N + 1, n_con(model)))
    u_prev = x0.new_zeros((NU,))
    z0_init = torch.cat([x0, u_prev])
    for _ in range(2):
        warm = solver_mod.solve(model, p, cfg, z0_init, us_warm, lam_warm)
        us_warm, lam_warm = warm.us, warm.lam
    return (x0, us_warm, lam_warm, u_prev)


def _step_fn(model, p, cfg, carry):
    """One control cycle: solve, clip the applied input, integrate the plant,
    shift the warm start.  Returns (carry, (x_next, u0, cost, violation, sdot))."""
    x, us_warm, lam_warm, u_prev = carry
    z0 = torch.cat([x, u_prev])
    res = solver_mod.solve(model, p, cfg, z0, us_warm, lam_warm)
    # actuator saturation: the AL solver leaves O(1e-2) slack on the input
    # boxes at fixed iteration budgets; the physical actuators (and the
    # reference's hard NLP bounds, src/mpc/controller.py:79-103) cannot
    # exceed them, so the APPLIED input is clipped to the rate limits and so
    # that the integrated steer/throttle states stay inside their boxes
    rate_lim = torch.stack([p.dsteer_max, p.dthrottle_max])
    box = torch.stack([p.steer_max, p.throttle_max])
    act = x[6:8]
    lo = torch.maximum(-rate_lim, (-box - act) / cfg.dt)
    hi = torch.minimum(rate_lim, (box - act) / cfg.dt)
    u0 = torch.clamp(res.us[0], lo, hi)
    x_next = model.step(x, u0, cfg.dt, substeps=cfg.substeps)
    # shift warm starts one stage forward
    us_next = torch.cat([res.us[1:], res.us[-1:]], dim=0)
    lam_next = torch.cat([res.lam[1:], res.lam[-1:]], dim=0)
    sdot = (x_next[0] - x[0]) / cfg.dt
    out = (x_next, u0, res.cost, res.max_violation, sdot)
    return (x_next, us_next, lam_next, u0), out


def closed_loop(model, p, cfg, x0: torch.Tensor, steps: int) -> SimResult:
    """Run `steps` control cycles from x0 on x0's device: the presolve, then
    `steps` × (solve → clip → plant → shift)."""
    xs = x0.new_empty((steps + 1, NX))
    us = x0.new_zeros((steps + 1, NU))
    costs, viols, sdots = (x0.new_empty((steps,)) for _ in range(3))
    xs[0] = x0
    carry = _presolve(model, p, cfg, x0)
    for t in range(steps):
        carry, (x_next, u0, cost, viol, sdot) = _step_fn(model, p, cfg, carry)
        xs[t + 1] = x_next
        us[t + 1] = u0
        costs[t] = cost
        viols[t] = viol
        sdots[t] = sdot
    return SimResult(xs=xs, us=us, costs=costs, violations=viols, sdot=sdots)


def applied_violation(model, p, result: SimResult) -> float:
    """Max constraint violation of the APPLIED closed-loop states/inputs
    against the TRUE (margin-0) band.  Pairs xs[1:] with us[1:] and a zero
    u_prev, as the JAX package does."""
    xs, us = result.xs, result.us
    z = torch.cat([xs[1:], xs.new_zeros((xs.shape[0] - 1, NU))], dim=1)
    return float(torch.max(solver_mod.constraints(model, p, z, us[1:])))


def tire_logs(model, xs: torch.Tensor):
    """Per-step slip angles and lateral forces (reference src/mpc.py:148-151)."""
    af, ar = model.slip_angles(xs[:, 3], xs[:, 4], xs[:, 5], xs[:, 6])
    fyf, fyr = model.lateral_forces(af, ar)
    return torch.stack([af, ar], dim=1), torch.stack([fyf, fyr], dim=1)


def to_sim_results(model, result: SimResult) -> dict:
    """Serialise with the reference `sim_results.json` schema
    (src/mpc.py:156-159): x/y of shape (steps+1, 8, 1), u (steps+1, 2, 1),
    Fy and alpha (steps+1, 2).  y == x (state-feedback estimator)."""
    xs = result.xs.detach().cpu().double().numpy()
    us = result.us.detach().cpu().double().numpy()
    alphas, fys = tire_logs(model, result.xs)
    alphas = alphas.detach().cpu().double().numpy().copy()
    fys = fys.detach().cpu().double().numpy().copy()
    # zero the t=0 log rows like the reference (src/mpc.py:134-135)
    alphas[0] = 0.0
    fys[0] = 0.0
    x_col = xs[:, :, None]
    u_col = us[:, :, None]
    return {
        "x": x_col.tolist(),
        "y": x_col.tolist(),
        "u": u_col.tolist(),
        "Fy": fys.tolist(),
        "alpha": alphas.tolist(),
    }
