"""Plain NumPy reference of one NMPC control cycle and of a closed loop.

The augmented-Lagrangian iLQR in Gauss-Newton mode over the augmented state
z = [x, u_prev]: a rollout of the warm start, then `al_iters` rounds, each
of `ilqr_iters` iterations (linearise and quadraticise every stage, a
Riccati sweep with Levenberg regularisation and the closed-form 2x2 inverse,
a ladder of `n_linesearch` step sizes 10^linspace(0, -2.5) of which the
first with the least AL cost is taken, kept only if it lowers the cost and
every gain is finite; the regularisation halves on success and grows 100x
on failure), then the PHR multiplier update and rho *= rho_scale.  One
control cycle solves from [x, u_prev], clips the first input to the rate
limits and so that the steer and throttle states stay in their boxes,
integrates the plant over dt, and shifts the warm start one stage.  Every
function takes a leading instance axis B (independent loops).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from perfbench.reference.model import NU, NX, NZ, N_CON, Model


@dataclasses.dataclass(frozen=True)
class Config:
    horizon: int = 10
    dt: float = 0.1
    substeps: int = 2
    al_iters: int = 2
    ilqr_iters: int = 5
    n_linesearch: int = 6
    rho_init: float = 20.0
    rho_scale: float = 5.0
    reg_init: float = 1e-6


def rollout(model: Model, cfg: Config, z0, us):
    zs = [z0]
    for k in range(us.shape[-2]):
        zs.append(np.concatenate([model.step(zs[-1][..., :NX], us[..., k, :], cfg.dt / cfg.substeps,
                                             cfg.substeps), us[..., k, :]], axis=-1))
    return np.stack(zs, axis=-2)


def _penalty(g, lam, rho):
    x = lam + rho * g
    return np.sum((np.maximum(x, 0.0) ** 2 - lam**2) / (2.0 * rho), axis=-1)


def al_cost(model: Model, zs, us, lams, rho):
    """Total AL cost of trajectories zs (..., N+1, NZ), us (..., N, NU)."""
    stage = model.stage_cost(zs[..., :-1, :], us) + _penalty(
        model.constraints(zs[..., :-1, :], us, model.lateral_margin), lams[..., :-1, :], rho)
    term = model.terminal_cost(zs[..., -1, :]) + _penalty(
        model.terminal_constraints(zs[..., -1, :], -1.0), lams[..., -1, :], rho)
    return np.sum(stage, axis=-1) + term


def _gn(P, r, g, Jr, Jg, lam, rho):
    phi = np.maximum(lam + rho * g, 0.0)
    act = np.where(phi > 0.0, rho, 0.0).astype(g.dtype)
    JrT, JgT = np.swapaxes(Jr, -1, -2), np.swapaxes(Jg, -1, -2)
    grad = 2.0 * P.mv(JrT, r) + P.mv(JgT, phi)
    hess = 2.0 * P.mm(JrT, Jr) + P.mm(JgT, act[..., None] * Jg)
    return grad, hess


def _iterate(model: Model, cfg: Config, zs, us, lams, rho, reg, alphas):
    """One iLQR iteration of every instance: (zs, us, cost, ok) of its best rung."""
    P = model.prec
    B, N = us.shape[0], us.shape[1]
    T = lambda M: np.swapaxes(M, -1, -2)
    _, J = model.step_and_jacobian(zs[:, :-1, :NX], us, cfg.dt / cfg.substeps, cfg.substeps)
    A = np.zeros((B, N, NZ, NZ), dtype=zs.dtype)
    A[..., :NX, :NX] = J[..., :NX]
    Bm = np.zeros((B, N, NZ, NU), dtype=zs.dtype)
    Bm[..., :NX, :] = J[..., NX:]
    Bm[..., NX:, :] = np.eye(NU, dtype=zs.dtype)
    r, g, Jr, Jg = model.stage_jacobians(zs[:, :-1], us)
    grad, hess = _gn(P, r, g, Jr, Jg, lams[:, :-1], rho)
    lz, lu = grad[..., :NZ], grad[..., NZ:]
    lzz, luu, luz = hess[..., :NZ, :NZ], hess[..., NZ:, NZ:], hess[..., NZ:, :NZ]
    zN = zs[:, -1]
    r, _, Jr, Jg = model.stage_jacobians(zN, zN[..., NX:])
    Vz, Vzz = _gn(P, r[..., :3], model.terminal_constraints(zN, -1.0), Jr[..., :3, :NZ], Jg[..., :NZ],
                  lams[:, -1], rho)
    eye = np.eye(NU, dtype=zs.dtype)
    ok = np.ones(B, dtype=bool)
    ks, Ks = [None] * N, [None] * N
    for k in reversed(range(N)):
        A_k, B_k = A[:, k], Bm[:, k]
        Qz = lz[:, k] + P.mv(T(A_k), Vz)
        Qu = lu[:, k] + P.mv(T(B_k), Vz)
        Qzz = lzz[:, k] + P.mm(P.mm(T(A_k), Vzz), A_k)
        Quu = luu[:, k] + P.mm(P.mm(T(B_k), Vzz), B_k)
        Quz = luz[:, k] + P.mm(P.mm(T(B_k), Vzz), A_k)
        Qr = Quu + reg[:, None, None] * eye
        a, b, c, d = Qr[:, 0, 0], Qr[:, 0, 1], Qr[:, 1, 0], Qr[:, 1, 1]
        det = a * d - b * c
        inv = np.stack([np.stack([d, -b], -1), np.stack([-c, a], -1)], -2) / det[:, None, None]
        with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
            kK = P.mm(inv, np.concatenate([Qu[..., None], Quz], axis=-1))
        k_k, K_k = -kK[..., 0], -kK[..., 1:]
        Vz = Qz + P.mv(P.mm(T(K_k), Quu), k_k) + P.mv(T(K_k), Qu) + P.mv(T(Quz), k_k)
        Vzz = Qzz + P.mm(P.mm(T(K_k), Quu), K_k) + P.mm(T(K_k), Quz) + P.mm(T(Quz), K_k)
        Vzz = 0.5 * (Vzz + T(Vzz))
        ok &= np.isfinite(k_k).all(axis=-1)
        ks[k], Ks[k] = k_k, K_k
    L = alphas.shape[0]
    z = np.broadcast_to(zs[:, :1], (B, L, NZ))
    z_r, u_r = [z], []
    h = cfg.dt / cfg.substeps
    for k in range(N):
        dz = z - zs[:, k:k + 1]
        u = us[:, k:k + 1] + alphas[:, None] * ks[k][:, None, :] + P.mm(dz, T(Ks[k]))
        z = np.concatenate([model.step(z[..., :NX], u, h, cfg.substeps), u], axis=-1)
        z_r.append(z)
        u_r.append(u)
    zs_l, us_l = np.stack(z_r, axis=-2), np.stack(u_r, axis=-2)
    with np.errstate(invalid="ignore", over="ignore"):
        costs = al_cost(model, zs_l, us_l, lams[:, None], rho)
    costs = np.where(np.isfinite(costs), costs, np.inf)
    best = np.argmin(costs, axis=-1)
    rows = np.arange(B)
    return zs_l[rows, best], us_l[rows, best], costs[rows, best], ok


def max_violation(model: Model, zs, us):
    """Largest violation of the true band (margin 0) over a trajectory."""
    g = model.constraints(zs[..., :-1, :], us, 0.0)
    zN = zs[..., -1, :]
    g_term = model.constraints(zN, np.zeros(zN.shape[:-1] + (NU,), dtype=zN.dtype), 0.0)
    g_term[..., 10:] = -np.inf
    return np.maximum(np.max(g, axis=(-2, -1)), np.max(g_term, axis=-1))


def solve(model: Model, cfg: Config, z0, us_init, lam_init):
    """The AL-iLQR solve of B OCPs from z0 (B, NZ), warm-started at us_init
    (B, N, NU) and lam_init (B, N+1, 14): (us, zs, lams, cost, max_violation)."""
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):  # diverged rungs are dropped by cost
        return _solve(model, cfg, z0, us_init, lam_init)


def _solve(model: Model, cfg: Config, z0, us_init, lam_init):
    dt = model.prec.dtype
    alphas = (10.0 ** np.linspace(0.0, -2.5, cfg.n_linesearch)).astype(dt)
    zs, us, lams = rollout(model, cfg, z0, us_init), us_init, lam_init
    rho = dt(cfg.rho_init)
    B = z0.shape[0]
    for _ in range(cfg.al_iters):
        cost = al_cost(model, zs, us, lams, rho)
        reg = np.full(B, cfg.reg_init, dtype=dt)
        for _ in range(cfg.ilqr_iters):
            zs_n, us_n, cost_n, ok = _iterate(model, cfg, zs, us, lams, rho, reg, alphas)
            better = (cost_n < cost) & ok
            zs = np.where(better[:, None, None], zs_n, zs)
            us = np.where(better[:, None, None], us_n, us)
            cost = np.where(better, cost_n, cost)
            reg = np.where(better, np.maximum(reg * dt(0.5), dt(cfg.reg_init)), reg * dt(100.0))
        g = np.concatenate([model.constraints(zs[:, :-1], us, model.lateral_margin),
                            model.terminal_constraints(zs[:, -1], -1.0)[:, None]], axis=1)
        lams = np.maximum(lams + rho * g, 0.0)
        rho = rho * dt(cfg.rho_scale)
    true_cost = np.sum(model.stage_cost(zs[:, :-1], us), axis=-1) + model.terminal_cost(zs[:, -1])
    return us, zs, lams, true_cost, max_violation(model, zs, us)


# ----------------------------------------------------------- closed loop
def presolve(model: Model, cfg: Config, x0):
    """The t = 0 warm start: two solves from [x0, 0] with zero inputs and
    multipliers.  Returns (us_warm, lam_warm)."""
    B, N = x0.shape[0], cfg.horizon
    dt = model.prec.dtype
    us = np.zeros((B, N, NU), dtype=dt)
    lams = np.zeros((B, N + 1, N_CON), dtype=dt)
    z0 = np.concatenate([x0, np.zeros((B, NU), dtype=dt)], axis=-1)
    for _ in range(2):
        us, _, lams, _, _ = solve(model, cfg, z0, us, lams)
    return us, lams


def clip_box(model: Model, cfg: Config, x):
    """The bounds (lo, hi), each (..., NU), of the input applied at state x:
    the rate limits, and the steer and throttle boxes one step ahead."""
    rate = np.stack([model.dsteer_max, model.dthrottle_max])
    box = np.stack([model.steer_max, model.throttle_max])
    act = x[..., 6:8]
    lo = np.maximum(-rate, (-box - act) / model.prec.dtype(cfg.dt))
    hi = np.minimum(rate, (box - act) / model.prec.dtype(cfg.dt))
    return lo, hi


def controller(model: Model, cfg: Config, x, u_prev, us_warm, lam_warm):
    """Solve from [x, u_prev] and clip the first input: (u0, cost,
    max_violation, us_warm', lam_warm') with the warm start shifted."""
    us, _, lams, cost, viol = solve(model, cfg, np.concatenate([x, u_prev], axis=-1), us_warm, lam_warm)
    lo, hi = clip_box(model, cfg, x)
    u0 = np.minimum(np.maximum(us[:, 0], lo), hi)
    shift = lambda a: np.concatenate([a[:, 1:], a[:, -1:]], axis=1)
    return u0, cost, viol, shift(us), shift(lams)


def plant(model: Model, cfg: Config, x, u):
    return model.step(x, u, cfg.dt / cfg.substeps, cfg.substeps)


def closed_loop(model: Model, cfg: Config, x0, steps: int) -> dict:
    """`steps` control cycles of B independent loops from x0 (B, NX), in the
    layout of the measured program's results: xs (B, steps+1, NX), us (B,
    steps+1, NU) with us[:, 0] = 0, costs, violations and sdot (B, steps)."""
    x = model.prec.arr(x0)
    B = x.shape[0]
    us_w, lam_w = presolve(model, cfg, x)
    u_prev = np.zeros((B, NU), dtype=x.dtype)
    out = {"xs": [x], "us": [u_prev], "costs": [], "violations": [], "sdot": []}
    for _ in range(steps):
        u0, cost, viol, us_w, lam_w = controller(model, cfg, x, u_prev, us_w, lam_w)
        x_next = plant(model, cfg, x, u0)
        out["sdot"].append((x_next[:, 0] - x[:, 0]) / x.dtype.type(cfg.dt))
        x, u_prev = x_next, u0
        out["xs"].append(x)
        out["us"].append(u0)
        out["costs"].append(cost)
        out["violations"].append(viol)
    return {k: np.stack(v, axis=1) for k, v in out.items()}


def follow(model: Model, cfg: Config, xs, us) -> dict:
    """The controller and the plant along given trajectories xs (B, T+1,
    NX), us (B, T+1, NU) (a closed loop's results): at each cycle t the
    reference solves from the given state xs[:, t] and last input us[:, t],
    warm-started by its own shifted solution of cycle t-1 (and the presolve
    from xs[:, 0] at t = 0), and steps the plant from xs[:, t] with its own
    clipped input.  Returns its inputs us (B, T, NU), next states xs (B, T,
    NX), costs and violations (B, T)."""
    xs, us = model.prec.arr(xs), model.prec.arr(us)
    us_w, lam_w = presolve(model, cfg, xs[:, 0])
    out = {"us": [], "xs": [], "costs": [], "violations": []}
    for t in range(xs.shape[1] - 1):
        u0, cost, viol, us_w, lam_w = controller(model, cfg, xs[:, t], us[:, t], us_w, lam_w)
        out["us"].append(u0)
        out["xs"].append(plant(model, cfg, xs[:, t], u0))
        out["costs"].append(cost)
        out["violations"].append(viol)
    return {k: np.stack(v, axis=1) for k, v in out.items()}


def applied_violation(model: Model, xs, us):
    """Per instance, the largest violation of the true band by the applied
    states and inputs (each input paired with the state it produced and a
    zero last input, as the program's `applied_violation` does)."""
    x = xs[:, 1:]
    z = np.concatenate([x, np.zeros(x.shape[:-1] + (NU,), dtype=x.dtype)], axis=-1)
    return np.max(model.constraints(z, us[:, 1:], 0.0), axis=(-2, -1))
