"""Closed-loop NMPC driver: solve → clip → plant step → warm-start shift.

Port of `lap_time_optimization_tpu/mpc/runner.py`: the single stream
(`closed_loop`), the same in chunks with a checkpoint (`closed_loop_chunked`)
and a fleet of independent loops on one device (`closed_loop_batch`).  Each
control cycle warm-starts the AL-iLQR from the shifted previous solution,
applies the first input, clipped to the actuator rate and box limits, and
integrates the plant (plant == model, like the reference's do_mpc simulator
over the same ODE).  The loop is eager PyTorch on the model's device; it
makes no host sync, so outputs are written into preallocated device tensors
and only checkpoints, `applied_violation` and `to_sim_results` copy to the
host.  The cycle code takes any leading instance shape: the batched loop
runs it on (B, ...) with `solver.solve_batch`.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch

from lap_time_optimization_tpu_torch.models.bicycle import NU, NX
from lap_time_optimization_tpu_torch.mpc import solver as solver_mod
from lap_time_optimization_tpu_torch.mpc.solver import n_con
from lap_time_optimization_tpu_torch.ops import ilqr
from lap_time_optimization_tpu_torch.utils import checkpoint

#: Reference initial state [s, n, mu, vx, vy, r, steer, throttle]
#: (src/mpc.py:107-110)
X0_REFERENCE = np.array([0.0, 0.0, 0.0, 5.0, 0.0, 0.0, 0.0, 0.1])


class SimResult(NamedTuple):
    # closed_loop_batch puts the instance axis B first on every field
    xs: torch.Tensor  # (steps+1, NX) states (x[0] = x0)
    us: torch.Tensor  # (steps+1, NU) applied inputs (u[0] = 0)
    costs: torch.Tensor  # (steps,) OCP cost per solve
    violations: torch.Tensor  # (steps,) max constraint violation per solve
    sdot: torch.Tensor  # (steps,) track progress rate per step


def _presolve(model, p, cfg, x0, solve=solver_mod.solve, pack=None):
    """Burn in the t=0 warm start (do_mpc's set_initial_guess analogue,
    reference src/mpc.py:118) and return the initial carry.  `pack`: the
    solve's constants (`ops.ilqr.pack`), built by the calling loop."""
    lead = x0.shape[:-1]
    N = cfg.horizon
    us_warm = x0.new_zeros(lead + (N, NU))
    lam_warm = x0.new_zeros(lead + (N + 1, n_con(model)))
    u_prev = x0.new_zeros(lead + (NU,))
    z0_init = torch.cat([x0, u_prev], dim=-1)
    for _ in range(2):
        warm = solve(model, p, cfg, z0_init, us_warm, lam_warm, pack)
        us_warm, lam_warm = warm.us, warm.lam
    return (x0, us_warm, lam_warm, u_prev)


def _step_fn(model, p, cfg, carry, solve=solver_mod.solve, pack=None):
    """One control cycle: solve, clip the applied input, integrate the plant,
    shift the warm start.  Returns (carry, (x_next, u0, cost, violation, sdot))."""
    x, us_warm, lam_warm, u_prev = carry
    z0 = torch.cat([x, u_prev], dim=-1)
    res = solve(model, p, cfg, z0, us_warm, lam_warm, pack)
    # actuator saturation: the AL solver leaves O(1e-2) slack on the input
    # boxes at fixed iteration budgets; the physical actuators (and the
    # reference's hard NLP bounds, src/mpc/controller.py:79-103) cannot
    # exceed them, so the APPLIED input is clipped to the rate limits and so
    # that the integrated steer/throttle states stay inside their boxes
    rate_lim = torch.stack([p.dsteer_max, p.dthrottle_max])
    box = torch.stack([p.steer_max, p.throttle_max])
    act = x[..., 6:8]
    lo = torch.maximum(-rate_lim, (-box - act) / cfg.dt)
    hi = torch.minimum(rate_lim, (box - act) / cfg.dt)
    u0 = torch.clamp(res.us[..., 0, :], lo, hi)
    x_next = model.step(x, u0, cfg.dt, substeps=cfg.substeps)
    # shift warm starts one stage forward
    us_next = torch.cat([res.us[..., 1:, :], res.us[..., -1:, :]], dim=-2)
    lam_next = torch.cat([res.lam[..., 1:, :], res.lam[..., -1:, :]], dim=-2)
    sdot = (x_next[..., 0] - x[..., 0]) / cfg.dt
    out = (x_next, u0, res.cost, res.max_violation, sdot)
    return (x_next, us_next, lam_next, u0), out


def _presolve_batch(model, p, cfg, x0_b, pack=None):
    """Batched burn-in (see `_presolve`): x0_b (B, NX), through `solver.solve_batch`."""
    return _presolve(model, p, cfg, x0_b, solver_mod.solve_batch, pack)


def _step_fn_batch(model, p, cfg, carry, pack=None):
    """Batched control cycle (see `_step_fn`): one `solver.solve_batch` for
    all B instances, then the elementwise clip and the plant step on (B, ...)."""
    return _step_fn(model, p, cfg, carry, solver_mod.solve_batch, pack)


def _empty_result(x0, steps) -> SimResult:
    """Preallocated outputs on x0's device, x[0] = x0 and u[0] = 0."""
    lead = x0.shape[:-1]
    xs = x0.new_empty(lead + (steps + 1, NX))
    xs[..., 0, :] = x0
    scalars = (x0.new_empty(lead + (steps,)) for _ in range(3))
    return SimResult(xs, x0.new_zeros(lead + (steps + 1, NU)), *scalars)


def _advance(model, p, cfg, carry, out: SimResult, start, stop, step_fn=_step_fn, pack=None):
    """Control cycles start..stop-1, written into `out`; returns the carry."""
    for t in range(start, stop):
        carry, (x_next, u0, cost, viol, sdot) = step_fn(model, p, cfg, carry, pack=pack)
        out.xs[..., t + 1, :] = x_next
        out.us[..., t + 1, :] = u0
        out.costs[..., t] = cost
        out.violations[..., t] = viol
        out.sdot[..., t] = sdot
    return carry


def closed_loop(model, p, cfg, x0: torch.Tensor, steps: int) -> SimResult:
    """Run `steps` control cycles from x0 on x0's device: the presolve, then
    `steps` × (solve → clip → plant → shift).  The solve's constants are
    packed once for the run."""
    out = _empty_result(x0, steps)
    pk = ilqr.pack(model, p, cfg)
    _advance(model, p, cfg, _presolve(model, p, cfg, x0, pack=pk), out, 0, steps, _step_fn, pk)
    return out


def closed_loop_batch(model, p, cfg, x0_batch: torch.Tensor, steps: int) -> SimResult:
    """A fleet of B independent closed loops (cars, scenarios, parameter
    variations) from x0_batch (B, NX): every control cycle solves all B OCPs
    with one `solver.solve_batch`.  Outputs carry the instance axis first:
    xs (B, steps+1, NX), us (B, steps+1, NU), costs/violations/sdot
    (B, steps).  Instance b follows `closed_loop` from x0_batch[b]."""
    out = _empty_result(x0_batch, steps)
    pk = ilqr.pack(model, p, cfg)
    carry = _presolve_batch(model, p, cfg, x0_batch, pk)
    _advance(model, p, cfg, carry, out, 0, steps, _step_fn_batch, pk)
    return out


def _sim_fingerprint(model, p, cfg, x0) -> str:
    """Digest of everything that determines a simulation's trajectory besides
    (steps, chunk): the model's flags, every model/track/OCP buffer (name,
    dtype, shape, bytes), the full solver config and x0.  A checkpoint written
    under anything else is ignored instead of spliced into this run."""
    h = hashlib.sha256()
    h.update(repr(cfg).encode())
    flags = (model.enable_traction_ellipse, model.enable_torque_vectoring, model.track.closed)
    h.update(repr(flags).encode())
    for prefix, module in (("model.", model), ("p.", p)):
        for name, t in module.state_dict().items():
            a = t.detach().cpu().numpy()
            h.update(f"{prefix}{name} {a.dtype} {a.shape}".encode() + a.tobytes())
    h.update(x0.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def closed_loop_chunked(model, p, cfg, x0: torch.Tensor, steps: int, chunk: int = 100,
                        checkpoint_path: str | None = None) -> SimResult:
    """`closed_loop` in chunks of `chunk` control cycles, with a checkpoint.

    The carry (plant state, warm-start inputs and multipliers, last input)
    crosses chunk boundaries unchanged, so the trajectory is identical to
    `closed_loop`'s.  With `checkpoint_path`, the carry and the outputs so
    far are saved as npz after every chunk but the last; a run restarted
    with the same arguments resumes at the last complete chunk and gives the
    same trajectory.  A checkpoint written for other steps, chunk, x0 or
    `_sim_fingerprint` is ignored."""
    out = _empty_result(x0, steps)
    if steps <= 0:
        return out
    done, carry = 0, None
    fingerprint = _sim_fingerprint(model, p, cfg, x0) if checkpoint_path is not None else ""
    if checkpoint_path is not None and checkpoint.exists(checkpoint_path):
        state = checkpoint.load(checkpoint_path)
        if (int(state["steps"]) == steps and int(state["chunk"]) == chunk
                and str(state["fingerprint"]) == fingerprint):
            done = int(state["done"])
            t = lambda name: torch.as_tensor(state[name], dtype=x0.dtype, device=x0.device)
            carry = tuple(t(f"carry{i}") for i in range(4))
            for name, a in zip(SimResult._fields, out):
                a[: state[name].shape[0]] = t(name)
    pk = ilqr.pack(model, p, cfg)
    if carry is None:
        carry = _presolve(model, p, cfg, x0, pack=pk)
    while done < steps:
        stop = min(done + chunk, steps)
        carry = _advance(model, p, cfg, carry, out, done, stop, _step_fn, pk)
        done = stop
        if checkpoint_path is not None and done < steps:
            host = lambda a: a.detach().cpu().numpy()
            checkpoint.save(
                checkpoint_path, steps=steps, chunk=chunk, done=done, fingerprint=fingerprint,
                xs=host(out.xs[: done + 1]), us=host(out.us[: done + 1]),
                costs=host(out.costs[:done]), violations=host(out.violations[:done]),
                sdot=host(out.sdot[:done]),
                **{f"carry{i}": host(c) for i, c in enumerate(carry)},
            )
    return out


def applied_violation(model, p, result: SimResult) -> float:
    """Max constraint violation of the APPLIED closed-loop states/inputs
    against the TRUE (margin-0) band, over every step (and every instance of
    a batch).  Pairs xs[1:] with us[1:] and a zero u_prev, as the JAX
    package does."""
    xs, us = result.xs[..., 1:, :], result.us[..., 1:, :]
    z = torch.cat([xs, xs.new_zeros(xs.shape[:-1] + (NU,))], dim=-1)
    return float(torch.max(solver_mod.constraints(model, p, z, us)))


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
