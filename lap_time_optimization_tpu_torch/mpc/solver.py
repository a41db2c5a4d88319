"""Augmented-Lagrangian iLQR for the horizon NMPC (Gauss-Newton mode).

Port of `lap_time_optimization_tpu/mpc/solver.py`.  The OCP is the same
(reference src/mpc/controller.py): the state is augmented with the previous
input, z = [x (8), u_prev (2)], so the Δu penalty is Markovian, and every
inequality is handled by one PHR augmented Lagrangian
    φ(g, λ, ρ) = 1/(2ρ)·(max(0, λ + ρ g)² − λ²).

On a CUDA device a whole Gauss-Newton solve is one launch of the
hand-written kernel behind `ops.ilqr.solve` (csrc/ilqr.cu: the rollout,
every AL round and iLQR iteration, the multiplier updates and the outputs,
one warp per OCP).  On the CPU `ops.ilqr.solve` runs the plain version,
`_solve` below: each iLQR iteration (`_iterate`) linearises the dynamics
and quadraticises the AL cost stage-parallel in PyTorch, with analytic
Jacobians, then runs the serial Riccati sweep and the line-search ladder in
the iteration twins `ops.ilqr.backward_forward_reference` (one OCP) /
`backward_forward_batch_reference` (a leading instance axis, for
`solve_batch`).  Accept/reject, regularisation escalation and the
multiplier update stay tensors combined with `torch.where`, so the plain
solve makes no host sync either.

`hessian_mode="exact"` quadraticises with the full Hessians of the AL
stage and terminal costs (`torch.func` over the stages) and runs `_solve`
on the tensors' own device, CPU or CUDA, as the JAX package runs exact
mode only on its XLA path: the kernel is Gauss-Newton only.

The solve's constants (`ops.ilqr.pack`) are built once by the closed loop
that runs many solves and passed down; `solve` called alone builds its own.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from lap_time_optimization_tpu_torch.models.bicycle import (
    IDX_DELTA,
    IDX_MU,
    IDX_N,
    IDX_S,
    IDX_THROTTLE,
    IDX_VX,
    IDX_VY,
    NU,
    NX,
    assemble,
    sign_jax,
)
from lap_time_optimization_tpu_torch.models.vehicle import GRAV
from lap_time_optimization_tpu_torch.ops import ilqr

NZ = NX + NU  # augmented state: model state + previous input
N_CON = 14  # stage inequality count for the default model (see `constraints`)
N_RES = 7  # stage residuals; the first N_RES_TERM form the terminal cost
N_RES_TERM = 3
HESSIAN_MODES = ("gauss_newton", "exact")


def n_con(model) -> int:
    """Stage inequality count: 14, +2 friction-ellipse rows when the model
    enables them (the warm-start multiplier buffers must match)."""
    return N_CON + 2 if model.enable_traction_ellipse else N_CON


def _state_row_mask(n: int, device) -> torch.Tensor:
    """Rows that are pure STATE constraints (they apply at the terminal stage
    too): the first 10 box/lateral rows and the friction-ellipse rows (14+);
    rows 10-13 are input boxes."""
    idx = torch.arange(n, device=device)
    return (idx < 10) | (idx >= 14)


class OCPParams(nn.Module):
    """Weights and limits as 0-d buffers, defaults = reference values
    (src/mpc/controller.py:9,24-31,79-103).  `lateral_margin` [m] shrinks the
    band the SOLVER sees; violations are always reported against the true
    band."""

    FIELDS = ("q_n", "q_mu", "q_B", "r_delta", "r_throttle", "vref_scale",
              "mu_max", "steer_max", "throttle_max", "dsteer_max", "dthrottle_max",
              "lateral_margin")

    def __init__(self, **values):
        super().__init__()
        values.setdefault("lateral_margin", 0.0)
        for name in self.FIELDS:
            self.register_buffer(name, torch.as_tensor(values[name], dtype=torch.float64))

    REFERENCE = dict(
        q_n=0.5, q_mu=3.0, q_B=1e-2, r_delta=1e-2, r_throttle=1e-2,
        vref_scale=0.6, mu_max=torch.pi * 0.5, steer_max=torch.pi / 4,
        throttle_max=1.0, dsteer_max=torch.pi / 2, dthrottle_max=1.0,
    )

    @classmethod
    def reference(cls, dtype=torch.float32, device=None, lateral_margin: float = 0.0) -> "OCPParams":
        return cls(**cls.REFERENCE, lateral_margin=lateral_margin).to(device=device, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    # Defaults tuned for warm-started closed-loop control.
    horizon: int = 10
    dt: float = 0.1
    substeps: int = 2
    al_iters: int = 2
    ilqr_iters: int = 5
    n_linesearch: int = 6
    rho_init: float = 20.0
    rho_scale: float = 5.0
    reg_init: float = 1e-6
    # "gauss_newton": exact gradients + JᵀJ Hessians of the residual and
    # constraint stacks (the cost is a nonlinear least squares; PSD by
    # construction); on CUDA tensors the solve kernel runs it.
    # "exact": full Hessians of the AL costs by torch.func; it runs the
    # plain solve `_solve` on the tensors' device (the kernel is GN only).
    hessian_mode: str = "gauss_newton"

    @classmethod
    def accurate(cls, horizon: int = 10, dt: float = 0.1) -> "SolverConfig":
        """High-accuracy preset for offline solves and correctness tests: 4
        RK4 substeps, 4 AL rounds × 8 iLQR iterations, 8 line-search rungs,
        ρ 10 → ×5 (a Gauss-Newton configuration: the solve kernel runs it)."""
        return cls(horizon=horizon, dt=dt, substeps=4, al_iters=4, ilqr_iters=8,
                   n_linesearch=8, rho_init=10.0, rho_scale=5.0)

    @classmethod
    def for_horizon(cls, horizon: int, dt: float = 0.1) -> "SolverConfig":
        """Real-time preset scaled to the horizon: long horizons run two stiff
        AL rounds with a gentle penalty ramp (ρ 200→400)."""
        if horizon <= 12:
            return cls(horizon=horizon, dt=dt)
        return cls(horizon=horizon, dt=dt, substeps=2, al_iters=2, ilqr_iters=5,
                   n_linesearch=6, rho_init=200.0, rho_scale=2.0)


class SolveResult(NamedTuple):
    us: torch.Tensor  # (N, NU) optimised inputs
    zs: torch.Tensor  # (N+1, NZ) optimised augmented trajectory
    lam: torch.Tensor  # (N+1, n_con) multipliers (terminal row: state rows)
    cost: torch.Tensor  # () AL-free cost
    max_violation: torch.Tensor  # () max constraint violation (true band)


# --------------------------------------------------------------------- pieces
# Every function below takes z (..., NZ) and u (..., NU) with any leading
# batch shape: stages, ladder rungs and vmap lanes go through the same code.
def dynamics_step(model, cfg: SolverConfig, z: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Augmented discrete dynamics: RK4 model step + u_prev := u."""
    x_next = model.step(z[..., :NX], u, cfg.dt, substeps=cfg.substeps)
    return torch.cat([x_next, u], dim=-1)


def stage_cost(model, p, z, u):
    """lterm + Δu rterm (reference src/mpc/controller.py:36-55)."""
    x = z[..., :NX]
    vref = model.track.v_ref(x[..., IDX_S])
    mterm = p.q_n * x[..., IDX_N] ** 2 + p.q_mu * x[..., IDX_MU] ** 2 + x[..., IDX_VY] ** 2
    lterm = mterm + (x[..., IDX_VX] - p.vref_scale * vref) ** 2 + model.beta_cost(x, p.q_B)
    du = u - z[..., NX:]
    rterm = p.r_delta * du[..., 0] ** 2 + p.r_throttle * du[..., 1] ** 2
    return lterm + rterm


def stage_residuals(model, p, z, u):
    """Weighted residuals r with stage_cost(z, u) == sum(r²): every term of
    the reference objective is a square, so the cost is a nonlinear least
    squares — the basis of the Gauss-Newton quadraticisation."""
    x = z[..., :NX]
    veh = model.vehicle
    vref = model.track.v_ref(x[..., IDX_S])
    b_dyn = torch.atan(x[..., IDX_VY] / torch.clamp(x[..., IDX_VX], min=1e-3))
    b_kin = torch.atan(x[..., IDX_DELTA] * veh.length_r / (veh.length_f + veh.length_r))
    du = u - z[..., NX:]
    return torch.stack(
        [
            torch.sqrt(p.q_n) * x[..., IDX_N],
            torch.sqrt(p.q_mu) * x[..., IDX_MU],
            x[..., IDX_VY],
            x[..., IDX_VX] - p.vref_scale * vref,
            torch.sqrt(p.q_B) * (b_dyn - b_kin),
            torch.sqrt(p.r_delta) * du[..., 0],
            torch.sqrt(p.r_throttle) * du[..., 1],
        ],
        dim=-1,
    )


def terminal_cost(model, p, z):
    """mterm (reference src/mpc/controller.py:52)."""
    x = z[..., :NX]
    return p.q_n * x[..., IDX_N] ** 2 + p.q_mu * x[..., IDX_MU] ** 2 + x[..., IDX_VY] ** 2


def constraints(model, p, z, u):
    """All stage inequalities g ≤ 0 against the TRUE band
    (reference src/mpc/controller.py:57-103)."""
    return _constraints(model, p, z, u, 0.0)


def tightened_constraints(model, p, z, u):
    """Constraints as the SOLVER sees them: the lateral band shrunk by
    `p.lateral_margin`."""
    return _constraints(model, p, z, u, p.lateral_margin)


def _constraints(model, p, z, u, lateral_margin):
    x = z[..., :NX]
    left, right = model.lateral_constraints(x[..., IDX_S], x[..., IDX_N], x[..., IDX_MU])
    rows = _box_rows(p, x, u, left + lateral_margin, right + lateral_margin)
    if model.enable_traction_ellipse:
        ef, er = model.traction_ellipse_physical(
            x[..., IDX_THROTTLE], x[..., IDX_VX], x[..., IDX_VY], x[..., 5], x[..., IDX_DELTA]
        )
        rows = torch.cat([rows, torch.stack([ef, er], dim=-1)], dim=-1)
    return rows


def _box_rows(p, x, u, left, right):
    return torch.stack(
        [
            left,
            right,
            -x[..., IDX_S],  # s ≥ 0
            x[..., IDX_MU] - p.mu_max,
            -x[..., IDX_MU] - p.mu_max,
            -x[..., IDX_VX],  # vx ≥ 0
            x[..., IDX_DELTA] - p.steer_max,
            -x[..., IDX_DELTA] - p.steer_max,
            x[..., IDX_THROTTLE] - p.throttle_max,
            -x[..., IDX_THROTTLE] - p.throttle_max,
            (u[..., 0] - p.dsteer_max).expand_as(left),
            (-u[..., 0] - p.dsteer_max).expand_as(left),
            (u[..., 1] - p.dthrottle_max).expand_as(left),
            (-u[..., 1] - p.dthrottle_max).expand_as(left),
        ],
        dim=-1,
    )


def _al_penalty(g, lam, rho):
    """PHR augmented-Lagrangian term for g ≤ 0, summed over the rows.
    `torch.maximum` (not `clamp`) so that at λ + ρg = 0 its derivative
    splits one half each way, as `jnp.maximum`'s does: the exact Hessian
    of a tied row is then ρ/4 · ∇g∇gᵀ, as in the JAX package.  The values
    are the same either way."""
    x = lam + rho * g
    shifted = torch.maximum(torch.zeros_like(x), x)
    return torch.sum((shifted**2 - lam**2) / (2.0 * rho), dim=-1)


def _masked_terminal_constraints(model, p, z):
    """Terminal constraints: state rows only (inputs do not exist at stage N);
    the input rows, evaluated at u = 0, are replaced by -1."""
    g = tightened_constraints(model, p, z, z.new_zeros(z.shape[:-1] + (NU,)))
    return torch.where(_state_row_mask(g.shape[-1], g.device), g, -1.0)


def al_stage_cost(model, p, z, u, lam, rho):
    return stage_cost(model, p, z, u) + _al_penalty(tightened_constraints(model, p, z, u), lam, rho)


def al_terminal_cost(model, p, z, lam, rho):
    return terminal_cost(model, p, z) + _al_penalty(_masked_terminal_constraints(model, p, z), lam, rho)


# ---------------------------------------------------------------------- solver
def _rollout(model, cfg, z0, us):
    zs = [z0]
    for k in range(us.shape[-2]):
        zs.append(dynamics_step(model, cfg, zs[-1], us[..., k, :]))
    return torch.stack(zs, dim=-2)


def _total_al_cost(model, p, zs, us, lams, rho):
    stage = al_stage_cost(model, p, zs[..., :-1, :], us, lams[..., :-1, :], rho)
    return torch.sum(stage, dim=-1) + al_terminal_cost(model, p, zs[..., -1, :], lams[..., -1, :], rho)


# From here on, zs (..., N+1, NZ), us (..., N, NU) and lams (..., N+1, n_con)
# may carry a leading instance axis: `solve_batch` goes through the same code.
def _true_cost(model, p, zs, us):
    stage = torch.sum(stage_cost(model, p, zs[..., :-1, :], us), dim=-1)
    return stage + terminal_cost(model, p, zs[..., -1, :])


def _max_violation(model, p, zs, us):
    """Max constraint violation (true band) of each trajectory."""
    g = constraints(model, p, zs[..., :-1, :], us)
    g_term = constraints(model, p, zs[..., -1, :], zs.new_zeros(zs.shape[:-2] + (NU,)))
    g_term = torch.where(_state_row_mask(g_term.shape[-1], g.device), g_term, -torch.inf)
    return torch.maximum(torch.amax(g, dim=(-2, -1)), torch.amax(g_term, dim=-1))


def _linearize_joint(model, cfg, zs, us):
    """(A, B) of the augmented dynamics at every stage: (..., N, NZ, NZ) and
    (..., N, NZ, NU).  x_next does not depend on u_prev, and u_prev' = u."""
    lead = us.shape[:-1]  # (..., N)
    _, J = model.step_and_jacobian(zs[..., :-1, :NX], us, cfg.dt, cfg.substeps)  # (..., N, NX, NX+NU)
    A = zs.new_zeros(lead + (NZ, NZ))
    A[..., :NX, :NX] = J[..., :NX]
    B = zs.new_zeros(lead + (NZ, NU))
    B[..., :NX, :] = J[..., NX:]
    B[..., NX:, :] = torch.eye(NU, dtype=zs.dtype, device=zs.device)
    return A, B


def _stage_jacobians(model, p, z, u):
    """Residuals r (..., 7) and tightened constraints g (..., n_con) with
    their Jacobians w.r.t. [z, u]: (..., 7, 12) and (..., n_con, 12).
    Analytic, for the reason given at `BicycleModel.rhs_and_jacobian`."""
    x = z[..., :NX]
    veh, track = model.vehicle, model.track
    s, mu, vx, vy, delta = (x[..., i] for i in (IDX_S, IDX_MU, IDX_VX, IDX_VY, IDX_DELTA))
    r = stage_residuals(model, p, z, u)
    g = tightened_constraints(model, p, z, u)

    _, dvref = track._uinterp_d(s, track.vref_vals)
    _, dnl = track._uinterp_d(s, track.nl_vals)
    _, dnr = track._uinterp_d(s, track.nr_vals)
    vx_safe = torch.clamp(vx, min=1e-3)
    # jnp.maximum's derivative: 1 above the floor, 1/2 on it, 0 below
    gate = (vx > 1e-3).to(vx.dtype) + 0.5 * (vx == 1e-3).to(vx.dtype)
    q = vy / vx_safe
    datan = torch.sqrt(p.q_B) / (1.0 + q * q)
    kin = veh.length_r / (veh.length_f + veh.length_r)
    b = delta * kin
    sq_d, sq_t = torch.sqrt(p.r_delta), torch.sqrt(p.r_throttle)
    res_rows = [
        # s  n  mu  vx  vy  r  delta  throttle  up0  up1  u0  u1
        [0, torch.sqrt(p.q_n), 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, torch.sqrt(p.q_mu), 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0],
        [-p.vref_scale * dvref, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, -datan * q / vx_safe * gate, datan / vx_safe, 0,
         -torch.sqrt(p.q_B) * kin / (1.0 + b * b), 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, -sq_d, 0, sq_d, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, -sq_t, 0, sq_t],
    ]
    half_len = 0.5 * (veh.length_f + veh.length_r)
    half_wid = 0.5 * veh.width
    lon_mu = half_len * torch.cos(torch.abs(mu)) * sign_jax(mu)
    lat_mu = -half_wid * torch.sin(mu)
    e = lambda col, v: [v if j == col else 0 for j in range(NZ + NU)]
    con_rows = [
        [-dnl, 1, -lon_mu + lat_mu, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [-dnr, -1, lon_mu + lat_mu, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        e(IDX_S, -1), e(IDX_MU, 1), e(IDX_MU, -1), e(IDX_VX, -1),
        e(IDX_DELTA, 1), e(IDX_DELTA, -1), e(IDX_THROTTLE, 1), e(IDX_THROTTLE, -1),
        e(NZ, 1), e(NZ, -1), e(NZ + 1, 1), e(NZ + 1, -1),
    ]
    if model.enable_traction_ellipse:
        Fy_f, Fy_r, dff, dfr = model.tyre_partials(vx, vy, x[..., 5], delta)
        wheelbase = veh.length_f + veh.length_r
        cap_f = (veh.D_f * veh.length_r * veh.mass * GRAV / wheelbase) ** 2
        cap_r = (veh.D_r * veh.length_f * veh.mass * GRAV / wheelbase) ** 2
        dlong = 2.0 * (0.5 * model.motor_force(x[..., IDX_THROTTLE])) * (0.5 * veh.C_m)
        con_rows += [
            [0, 0, 0, *(2.0 * Fy_f * d / cap_f for d in dff), dlong / cap_f, 0, 0, 0, 0],
            [0, 0, 0, *(2.0 * Fy_r * d / cap_r for d in dfr), 0, dlong / cap_r, 0, 0, 0, 0],
        ]
    return r, g, assemble(res_rows, s), assemble(con_rows, s)


def _gn(r, g, Jr, Jg, lam, rho):
    """Exact gradient + Gauss-Newton Hessian of Σ r² + Σ φ(g, λ, ρ):
      ∇  = 2 Jrᵀ r + Jgᵀ φ'            (φ' = max(0, λ+ρg))
      ∇² ≈ 2 JrᵀJr + ρ Jgᵀ diag(act) Jg."""
    phi = torch.clamp(lam + rho * g, min=0.0)
    act = torch.where(phi > 0.0, rho, 0.0)
    JrT, JgT = Jr.transpose(-1, -2), Jg.transpose(-1, -2)
    grad = 2.0 * (JrT @ r.unsqueeze(-1)).squeeze(-1) + (JgT @ phi.unsqueeze(-1)).squeeze(-1)
    hess = 2.0 * JrT @ Jr + JgT @ (act.unsqueeze(-1) * Jg)
    return grad, hess


def _quads_gauss_newton(model, p, zs, us, lams, rho):
    """GN quadraticisation of the AL stage cost at every stage (leading axis
    of zs/us/lams).  Returns lz, lu, lzz, luu, luz."""
    r, g, Jr, Jg = _stage_jacobians(model, p, zs, us)
    grad, hess = _gn(r, g, Jr, Jg, lams, rho)
    return grad[..., :NZ], grad[..., NZ:], hess[..., :NZ, :NZ], hess[..., NZ:, NZ:], hess[..., NZ:, :NZ]


def _terminal_quads_gauss_newton(model, p, z, lam, rho):
    """GN quadraticisation of the terminal cost (mterm + masked AL): the
    stage Jacobians at u = u_prev, restricted to the terminal residuals and
    to z; the masked input rows depend on u only, so their z-rows are 0."""
    r, _, Jr, Jg = _stage_jacobians(model, p, z, z[..., NX:])
    g = _masked_terminal_constraints(model, p, z)
    return _gn(r[..., :N_RES_TERM], g, Jr[..., :N_RES_TERM, :NZ], Jg[..., :NZ], lam, rho)


def _value_grad_hessian(f, x):
    """(∇f(x), ∇²f(x)) of a scalar function of one vector, by forward over
    reverse mode."""
    def grad_twice(y):
        g = torch.func.grad(f)(y)
        return g, g

    hess, grad = torch.func.jacfwd(grad_twice, has_aux=True)(x)
    return grad, hess


def _over_lead(fn, *args):
    """`fn` of single-instance arguments mapped by `torch.func.vmap` over
    the leading shape shared by `args` (each arg carries one trailing dim)."""
    lead = args[0].shape[:-1]
    flat = [a.reshape((-1,) + a.shape[-1:]) for a in args]
    outs = torch.func.vmap(fn)(*flat)
    return tuple(o.reshape(lead + o.shape[1:]) for o in outs)


def _quads_exact(model, p, zs, us, lams, rho):
    """Full second-order quadraticisation of the AL stage cost at every
    stage (any leading shape of zs/us/lams), as the JAX package's
    `_quads_exact` (jax.hessian): gradient and Hessian over [z, u].
    Returns lz, lu, lzz, luu, luz."""
    def one(zu, lam):
        return _value_grad_hessian(lambda y: al_stage_cost(model, p, y[:NZ], y[NZ:], lam, rho), zu)

    grad, hess = _over_lead(one, torch.cat([zs, us], dim=-1), lams)
    return grad[..., :NZ], grad[..., NZ:], hess[..., :NZ, :NZ], hess[..., NZ:, NZ:], hess[..., NZ:, :NZ]


def _terminal_quads_exact(model, p, z, lam, rho):
    """Gradient and Hessian of the terminal AL cost over z (Vz, Vzz)."""
    return _over_lead(
        lambda zz, ll: _value_grad_hessian(lambda y: al_terminal_cost(model, p, y, ll, rho), zz), z, lam)


def _kernel_inputs(model, p, cfg, zs, us, lams, rho):
    """The iteration twins' per-instance inputs, contiguous: stage
    Jacobians A, B, the stage quads and the terminal quads (Gauss-Newton or
    exact, by `cfg.hessian_mode`)."""
    A, B = _linearize_joint(model, cfg, zs, us)
    if cfg.hessian_mode == "exact":
        quads, terminal = _quads_exact, _terminal_quads_exact
    else:
        quads, terminal = _quads_gauss_newton, _terminal_quads_gauss_newton
    stage = quads(model, p, zs[..., :-1, :], us, lams[..., :-1, :], rho)
    Vz, Vzz = terminal(model, p, zs[..., -1, :], lams[..., -1, :], rho)
    return [t.contiguous() for t in (A, B, *stage, Vz, Vzz)]


def _iterate(model, p, cfg, zs, us, lams, rho, reg, pk):
    """One iLQR iteration in plain PyTorch: linearisation + GN quads here,
    the serial Riccati sweep + line-search ladder in the iteration twin
    (`backward_forward_reference` for one OCP, reg 0-d;
    `backward_forward_batch_reference` for a batch, instance b at reg[b],
    the reg slot of the shared scalar vector unused).  rho and reg stay
    0-d device tensors: the scalar vector is spliced together on the
    device, so the loop uploads nothing."""
    inputs = (*_kernel_inputs(model, p, cfg, zs, us, lams, rho),
              zs.contiguous(), us.contiguous(), lams.contiguous(), pk.tables, pk.alphas)
    if reg.dim() == 0:
        scal = torch.cat([rho.reshape(1), reg.reshape(1), pk.scal_tail])
        out = ilqr.backward_forward_reference(*inputs, scal, substeps=cfg.substeps)
    else:
        scal = torch.cat([rho.reshape(1), torch.zeros_like(rho).reshape(1), pk.scal_tail])
        out = ilqr.backward_forward_batch_reference(*inputs, scal, reg, substeps=cfg.substeps)
    zs_new, us_new, new_cost, ok = out
    return new_cost, zs_new, us_new, ok < 0.5


def _update_multipliers(model, p, zs, us, lams, rho):
    """PHR multiplier update on the tightened band the AL optimises."""
    g_stage = tightened_constraints(model, p, zs[..., :-1, :], us)
    g_term = _masked_terminal_constraints(model, p, zs[..., -1, :])
    g_all = torch.cat([g_stage, g_term.unsqueeze(-2)], dim=-2)
    return torch.clamp(lams + rho * g_all, min=0.0)


def _solve(model, p, cfg, z0, us_init, lam_init, pk) -> SolveResult:
    """The plain solve: the AL rounds around `_iterate`, for one OCP
    (z0 (NZ,)) or a batch (z0 (B, NZ)), with the constants `pk`.  One rho
    schedule for all instances; accept/reject and reg escalation are per
    instance, through `torch.where` on masks of z0's leading shape, with no
    host sync."""
    if cfg.hessian_mode not in HESSIAN_MODES:
        raise ValueError(f"hessian_mode={cfg.hessian_mode!r} is not one of {HESSIAN_MODES}")
    dtype, device = z0.dtype, z0.device
    zs = _rollout(model, cfg, z0, us_init)
    us, lams = us_init, lam_init
    rho = torch.full((), cfg.rho_init, dtype=dtype, device=device)

    for _ in range(cfg.al_iters):
        cost = _total_al_cost(model, p, zs, us, lams, rho)
        reg = torch.full(z0.shape[:-1], cfg.reg_init, dtype=dtype, device=device)
        for _ in range(cfg.ilqr_iters):
            new_cost, zs_new, us_new, diverged = _iterate(model, p, cfg, zs, us, lams, rho, reg, pk)
            improved = (new_cost < cost) & ~diverged
            take = improved[..., None, None]
            zs = torch.where(take, zs_new, zs)
            us = torch.where(take, us_new, us)
            cost = torch.where(improved, new_cost, cost)
            # aggressive escalation: with few iLQR iterations per solve, a
            # rejected step must not burn the remaining budget at useless reg
            reg = torch.where(improved, torch.clamp(reg * 0.5, min=cfg.reg_init), reg * 100.0)
        lams = _update_multipliers(model, p, zs, us, lams, rho)
        rho = rho * cfg.rho_scale

    return SolveResult(
        us=us, zs=zs, lam=lams,
        cost=_true_cost(model, p, zs, us),
        max_violation=_max_violation(model, p, zs, us),
    )


def _dispatch(model, p, cfg, z0, us_init, lam_init, pack) -> SolveResult:
    """Gauss-Newton: `ops.ilqr.solve` (the kernel on CUDA tensors, the
    plain solve on the CPU).  Exact: the plain solve on z0's device, the
    counterpart of JAX's exact mode, which runs on its XLA path only."""
    pk = ilqr.pack(model, p, cfg) if pack is None else pack
    if cfg.hessian_mode == "exact":
        return _solve(model, p, cfg, z0, us_init, lam_init, pk)
    return SolveResult(*ilqr.solve(model, p, cfg, z0, us_init, lam_init, pk))


def solve(model, p, cfg: SolverConfig, z0, us_init, lam_init, pack=None) -> SolveResult:
    """Solve the horizon OCP from z0 (NZ,), warm-started at us_init (N, NU)
    and lam_init (N+1, n_con), with the constants `pack` (`ops.ilqr.pack`;
    built here if None).  On CUDA tensors in Gauss-Newton mode: one launch
    of the solve kernel; exact mode runs the plain solve."""
    if z0.dim() != 1:
        raise ValueError(f"solve takes one OCP, z0 (NZ,); got {tuple(z0.shape)}: use solve_batch")
    return _dispatch(model, p, cfg, z0, us_init, lam_init, pack)


def solve_batch(model, p, cfg: SolverConfig, z0_b, us_init_b, lam_init_b, pack=None) -> SolveResult:
    """Solve B independent horizon OCPs (leading axis B on every argument
    and on every field of the result).  Per instance it is `solve`: the same
    AL schedule, with per-instance step acceptance and reg escalation.  On
    CUDA tensors in Gauss-Newton mode: one launch of the solve kernel for
    all B; exact mode runs the plain solve over the batch."""
    if z0_b.dim() != 2:
        raise ValueError(f"solve_batch takes z0_b (B, NZ); got {tuple(z0_b.shape)}")
    return _dispatch(model, p, cfg, z0_b, us_init_b, lam_init_b, pack)
