"""Curvilinear dynamic bicycle model with simplified Pacejka tyres.

Port of `lap_time_optimization_tpu/models/bicycle.py` (reference
src/mpc/model.py:130-185, with its sign conventions):

  states  x = [s, n, mu, vx, vy, r, steering_angle, throttle]
  inputs  u = [steering_angle_change, throttle_change]

  sdot   = (vx cos(mu) − vy sin(mu)) / (1 − n k(s))
  ndot   = vx sin(mu) + vy cos(mu)
  mudot  = r − k(s)·sdot
  vxdot  = (Fx − Fy_f sin(δ) + m vy r)/m
  vydot  = (Fy_r + Fy_f cos(δ) − m vx r)/m
  rdot   = (Fy_f l_f cos(δ) − Fy_r l_r + Mtv)/I_z
  δdot   = u₀ ;  throttledot = u₁

Every function takes states and inputs with any leading batch shape
(`x[..., i]`), so a horizon, a line-search ladder or a `torch.func.vmap`
lane all go through the same code.  The discrete step is explicit RK4 with
substeps.  Torque vectoring (`Mtv = ptv·(tan(δ)·vx/L − r)`) is on behind
`enable_torque_vectoring`, here and in the CUDA solve kernel alike.
"""

from __future__ import annotations

import torch
from torch import nn

from lap_time_optimization_tpu_torch.models.vehicle import GRAV, PacejkaVehicle
from lap_time_optimization_tpu_torch.mpc.track import MPCTrack

NX = 8  # model states
NU = 2  # inputs

IDX_S, IDX_N, IDX_MU, IDX_VX, IDX_VY, IDX_R, IDX_DELTA, IDX_THROTTLE = range(8)


def sign_jax(x: torch.Tensor) -> torch.Tensor:
    """d|x|/dx as JAX's AD takes it: +1 at 0 (torch's sign gives 0).  The
    reference state has mu = 0 exactly, so the lateral-band Jacobian depends
    on this convention."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def assemble(rows, like: torch.Tensor) -> torch.Tensor:
    """Stack a nested list of partials into a (..., R, C) Jacobian; numbers
    and 0-d parameters broadcast to `like`'s shape."""
    zero = torch.zeros_like(like)
    flat = []
    for row in rows:
        for e in row:
            if isinstance(e, (int, float)):
                flat.append(zero if e == 0 else torch.full_like(like, e))
            else:
                flat.append(e.expand_as(like))
    return torch.stack(flat, dim=-1).reshape(like.shape + (len(rows), len(rows[0])))


class BicycleModel(nn.Module):
    def __init__(self, vehicle: PacejkaVehicle, track: MPCTrack,
                 enable_torque_vectoring: bool = False,
                 enable_traction_ellipse: bool = False):
        super().__init__()
        self.vehicle = vehicle
        self.track = track
        self.enable_torque_vectoring = enable_torque_vectoring
        # adds the friction-ellipse rows to the solver's constraint set, in
        # the dimensionally consistent form of `traction_ellipse_physical`
        self.enable_traction_ellipse = enable_traction_ellipse

    # ------------------------------------------------------------ tyre model
    def slip_angles(self, vx, vy, r, delta):
        """(α_f, α_r) — reference src/mpc/model.py:101-104."""
        veh = self.vehicle
        alpha_f = torch.atan2(vy + veh.length_f * r, vx) - delta
        alpha_r = torch.atan2(vy - veh.length_r * r, vx)
        return alpha_f, alpha_r

    def lateral_forces(self, alpha_f, alpha_r):
        """Negated Pacejka with static load split — src/mpc/model.py:106-114."""
        veh = self.vehicle
        wheelbase = veh.length_f + veh.length_r
        Fn_f = veh.length_r * veh.mass * GRAV / wheelbase
        Fn_r = veh.length_f * veh.mass * GRAV / wheelbase
        Fy_f = -Fn_f * veh.D_f * torch.sin(veh.C_f * torch.atan(veh.B_f * alpha_f))
        Fy_r = -Fn_r * veh.D_r * torch.sin(veh.C_r * torch.atan(veh.B_r * alpha_r))
        return Fy_f, Fy_r

    def motor_force(self, throttle):
        return self.vehicle.C_m * throttle  # src/mpc/model.py:116-117

    # -------------------------------------------------------------- dynamics
    def rhs(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Continuous-time RHS (src/mpc/model.py:152-183)."""
        veh = self.vehicle
        s, n, mu, vx, vy, r, delta, throttle = (x[..., i] for i in range(NX))
        k = self.track.curvature(s)
        sdot = (vx * torch.cos(mu) - vy * torch.sin(mu)) / (1.0 - n * k)
        alpha_f, alpha_r = self.slip_angles(vx, vy, r, delta)
        Fy_f, Fy_r = self.lateral_forces(alpha_f, alpha_r)
        Fx = self.motor_force(throttle) - veh.Cr_0 - veh.Cr_2 * vx * vx
        yaw = Fy_f * veh.length_f * torch.cos(delta) - Fy_r * veh.length_r
        if self.enable_torque_vectoring:
            rt = torch.tan(delta) * vx / (veh.length_f + veh.length_r)
            yaw = yaw + veh.ptv * (rt - r)  # src/mpc/model.py:162-163 (zeroed there)
        return torch.stack(
            [
                sdot,
                vx * torch.sin(mu) + vy * torch.cos(mu),
                r - k * sdot,
                (Fx - Fy_f * torch.sin(delta) + veh.mass * vy * r) / veh.mass,
                (Fy_r + Fy_f * torch.cos(delta) - veh.mass * vx * r) / veh.mass,
                yaw / veh.rotational_inertia,
                u[..., 0].expand_as(s),
                u[..., 1].expand_as(s),
            ],
            dim=-1,
        )

    def tyre_partials(self, vx, vy, r, delta):
        """(Fy_f, Fy_r) and their partials: dFy_f w.r.t. (vx, vy, r, δ) and
        dFy_r w.r.t. (vx, vy, r) (it does not depend on δ)."""
        veh = self.vehicle
        yf = vy + veh.length_f * r
        yr = vy - veh.length_r * r
        alpha_f = torch.atan2(yf, vx) - delta
        alpha_r = torch.atan2(yr, vx)
        Fy_f, Fy_r = self.lateral_forces(alpha_f, alpha_r)
        wheelbase = veh.length_f + veh.length_r
        Fn_f = veh.length_r * veh.mass * GRAV / wheelbase
        Fn_r = veh.length_f * veh.mass * GRAV / wheelbase
        bf, br = veh.B_f * alpha_f, veh.B_r * alpha_r
        gf = -Fn_f * veh.D_f * torch.cos(veh.C_f * torch.atan(bf)) * veh.C_f * veh.B_f / (1.0 + bf * bf)
        gr = -Fn_r * veh.D_r * torch.cos(veh.C_r * torch.atan(br)) * veh.C_r * veh.B_r / (1.0 + br * br)
        # d atan2(y, x) = (x dy - y dx) / (x² + y²)
        qf = gf / (vx * vx + yf * yf)
        qr = gr / (vx * vx + yr * yr)
        dFy_f = (-yf * qf, vx * qf, veh.length_f * vx * qf, -gf)
        dFy_r = (-yr * qr, vx * qr, -veh.length_r * vx * qr)
        return Fy_f, Fy_r, dFy_f, dFy_r

    def rhs_and_jacobian(self, x: torch.Tensor, u: torch.Tensor):
        """RHS and its Jacobian w.r.t. [x, u]: (..., 8) and (..., 8, 10).

        Analytic partials: forward-mode AD in PyTorch re-enters Python for
        every op that broadcasts a tangent against a parameter, which is most
        of this function.  At the non-smooth points the partials follow the
        JAX package's AD conventions (`MPCTrack._uinterp_d`)."""
        veh = self.vehicle
        s, n, mu, vx, vy, r, delta, throttle = (x[..., i] for i in range(NX))
        k, dk = self.track._uinterp_d(s, self.track.k_vals)
        cos_mu, sin_mu = torch.cos(mu), torch.sin(mu)
        den = 1.0 - n * k
        num = vx * cos_mu - vy * sin_mu
        sdot = num / den
        sd_s = sdot * n * dk / den
        sd_n = sdot * k / den
        sd_mu = (-vx * sin_mu - vy * cos_mu) / den
        sd_vx = cos_mu / den
        sd_vy = -sin_mu / den

        Fy_f, Fy_r, (ff_vx, ff_vy, ff_r, ff_d), (fr_vx, fr_vy, fr_r) = self.tyre_partials(vx, vy, r, delta)
        m, lf, lr = veh.mass, veh.length_f, veh.length_r
        Fx = self.motor_force(throttle) - veh.Cr_0 - veh.Cr_2 * vx * vx
        cos_d, sin_d = torch.cos(delta), torch.sin(delta)
        yaw = Fy_f * lf * cos_d - Fy_r * lr
        m_vx = m_r = m_d = 0.0
        if self.enable_torque_vectoring:
            tan_d = torch.tan(delta)
            rt = tan_d * vx / (lf + lr)
            yaw = yaw + veh.ptv * (rt - r)
            m_vx = veh.ptv * tan_d / (lf + lr)
            m_r = -veh.ptv
            m_d = veh.ptv * vx * (1.0 + tan_d * tan_d) / (lf + lr)
        f = torch.stack(
            [
                sdot,
                vx * sin_mu + vy * cos_mu,
                r - k * sdot,
                (Fx - Fy_f * sin_d + m * vy * r) / m,
                (Fy_r + Fy_f * cos_d - m * vx * r) / m,
                yaw / veh.rotational_inertia,
                u[..., 0].expand_as(s),
                u[..., 1].expand_as(s),
            ],
            dim=-1,
        )
        Iz = veh.rotational_inertia
        rows = [
            # s      n       mu       vx       vy       r      delta  throttle u0 u1
            [sd_s, sd_n, sd_mu, sd_vx, sd_vy, 0, 0, 0, 0, 0],
            [0, 0, num, sin_mu, cos_mu, 0, 0, 0, 0, 0],
            [-(dk * sdot + k * sd_s), -k * sd_n, -k * sd_mu, -k * sd_vx, -k * sd_vy, 1, 0, 0, 0, 0],
            [0, 0, 0, (-2.0 * veh.Cr_2 * vx - ff_vx * sin_d) / m, (-ff_vy * sin_d + m * r) / m,
             (-ff_r * sin_d + m * vy) / m, (-ff_d * sin_d - Fy_f * cos_d) / m, veh.C_m / m, 0, 0],
            [0, 0, 0, (fr_vx + ff_vx * cos_d - m * r) / m, (fr_vy + ff_vy * cos_d) / m,
             (fr_r + ff_r * cos_d - m * vx) / m, (ff_d * cos_d - Fy_f * sin_d) / m, 0, 0, 0],
            [0, 0, 0, (ff_vx * lf * cos_d - fr_vx * lr + m_vx) / Iz, (ff_vy * lf * cos_d - fr_vy * lr) / Iz,
             (ff_r * lf * cos_d - fr_r * lr + m_r) / Iz, (ff_d * lf * cos_d - Fy_f * lf * sin_d + m_d) / Iz,
             0, 0, 0],
            [0, 0, 0, 0, 0, 0, 0, 0, 1, 0],
            [0, 0, 0, 0, 0, 0, 0, 0, 0, 1],
        ]
        return f, assemble(rows, s)

    def step(self, x: torch.Tensor, u: torch.Tensor, dt: float, substeps: int = 4) -> torch.Tensor:
        """Explicit RK4 over `substeps` increments (plant == model, like the
        reference's do_mpc simulator over the same ODE)."""
        return self.rk4(x, u, dt / substeps, substeps)

    def step_and_jacobian(self, x: torch.Tensor, u: torch.Tensor, dt: float, substeps: int):
        """`step` and its Jacobian w.r.t. [x, u]: (..., 8) and (..., 8, 10),
        by carrying the tangents through every RK4 stage."""
        h = dt / substeps
        dX = torch.eye(NX, NX + NU, dtype=x.dtype, device=x.device).expand(x.shape[:-1] + (NX, NX + NU))
        # d rhs / d u: the steer and throttle rates are the inputs
        E = torch.zeros((NX, NX + NU), dtype=x.dtype, device=x.device)
        E[IDX_DELTA, NX] = E[IDX_THROTTLE, NX + 1] = 1.0

        def stage(xs, dXs):
            f, J = self.rhs_and_jacobian(xs, u)
            return f, J[..., :NX] @ dXs + E

        for _ in range(substeps):
            k1, d1 = stage(x, dX)
            k2, d2 = stage(x + 0.5 * h * k1, dX + 0.5 * h * d1)
            k3, d3 = stage(x + 0.5 * h * k2, dX + 0.5 * h * d2)
            k4, d4 = stage(x + h * k3, dX + h * d3)
            x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            dX = dX + (h / 6.0) * (d1 + 2 * d2 + 2 * d3 + d4)
        return x, dX

    def rk4(self, x: torch.Tensor, u: torch.Tensor, h, substeps: int) -> torch.Tensor:
        """`substeps` RK4 increments of size h (a float or a 0-d tensor)."""
        for _ in range(substeps):
            k1 = self.rhs(x, u)
            k2 = self.rhs(x + 0.5 * h * k1, u)
            k3 = self.rhs(x + 0.5 * h * k2, u)
            k4 = self.rhs(x + h * k3, u)
            x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        return x

    # ------------------------------------------------------------ constraints
    def lateral_constraints(self, s, n, mu):
        """Track-limit constraints ≤ 0 incl. car footprint
        (src/mpc/model.py:70-84; sign(mu)*mu ≡ |mu|)."""
        veh = self.vehicle
        half_len = 0.5 * (veh.length_f + veh.length_r)
        half_wid = 0.5 * veh.width
        lon = half_len * torch.sin(torch.abs(mu))
        lat = half_wid * torch.cos(mu)
        left = n - lon + lat - self.track.dist_left(s)
        right = -n + lon + lat - self.track.dist_right(s)
        return left, right

    def traction_ellipse(self, throttle, vx, vy, r, delta, rho=1.0, alpha=1.0):
        """The reference's friction-ellipse residuals, as it wrote them
        (src/mpc/model.py:86-99, defined but disabled there):

            g = (ρ·Fx/2)² + Fy² − (α·D)²

        per axle.  They compare forces in N² against the normalised Pacejka
        peak D² and cannot be met; the solver's rows use
        `traction_ellipse_physical`."""
        veh = self.vehicle
        longf = rho * 0.5 * self.motor_force(throttle)
        af, ar = self.slip_angles(vx, vy, r, delta)
        Fy_f, Fy_r = self.lateral_forces(af, ar)
        Df = alpha * veh.D_f
        Dr = alpha * veh.D_r
        return longf**2 + Fy_f**2 - Df**2, longf**2 + Fy_r**2 - Dr**2

    def traction_ellipse_physical(self, throttle, vx, vy, r, delta, rho=1.0, alpha=1.0):
        """Dimensionally consistent friction-ellipse residuals ≤ 0:

            g = ((ρ·Fx/2)² + Fy² − (α·D·Fn)²) / (α·D·Fn)²

        (`traction_ellipse`, the reference's form, is unsatisfiable)."""
        veh = self.vehicle
        wheelbase = veh.length_f + veh.length_r
        Fn_f = veh.length_r * veh.mass * GRAV / wheelbase
        Fn_r = veh.length_f * veh.mass * GRAV / wheelbase
        longf = rho * 0.5 * self.motor_force(throttle)
        af, ar = self.slip_angles(vx, vy, r, delta)
        Fy_f, Fy_r = self.lateral_forces(af, ar)
        cap_f = (alpha * veh.D_f * Fn_f) ** 2
        cap_r = (alpha * veh.D_r * Fn_r) ** 2
        return (
            (longf**2 + Fy_f**2 - cap_f) / cap_f,
            (longf**2 + Fy_r**2 - cap_r) / cap_r,
        )

    def beta_cost(self, x: torch.Tensor, q_B) -> torch.Tensor:
        """Kinematic/dynamic side-slip consistency cost B(q_B)
        (src/mpc/model.py:124-128), guarded at vx → 0."""
        veh = self.vehicle
        vx = x[..., IDX_VX]
        b_dyn = torch.atan(x[..., IDX_VY] / torch.clamp(vx, min=1e-3))
        b_kin = torch.atan(x[..., IDX_DELTA] * veh.length_r / (veh.length_f + veh.length_r))
        return q_B * (b_dyn - b_kin) ** 2
